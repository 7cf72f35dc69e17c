// Streaming-softmax (flash) attention for Hopper (sm_90a), float32 or
// bfloat16 in and out, float32 sums inside.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`) in
// src/repro/kernels/flash_attention.py. It computes the function of
// `blockwise_attention` (src/repro/models/layers.py), of which the Pallas
// kernel is the case H == Hkv, kv_offset == 0 in a [B, H, S, D] layout;
// semantics are those of `flash_attention_ref` (src/repro_torch/kernels/
// ref.py). Over the model's layout q [B, Sq, H, D], k [B, Skv, Hkv, D],
// v [B, Skv, Hkv, Dv] (Dv <= D: MLA's heads are 192 / 128 over the full
// sequence and 576 / 512 in its weight-absorbed cached form):
//
//   row i of q sits at position q_off + i, key j at position kv_off + j;
//   (i, j) is kept when 0 <= kv_off + j, and, if causal, kv_off + j <= q_off
//   + i, and, with window > 0, kv_off + j >= q_off + i - window + 1;
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / (H / Hkv)]
//                  over the kept j) @ v[b, :, h / (H / Hkv)]  (Dv wide),
//   and 0 for a row with no kept key (not NaN).
//
// The running max starts at -1e30 and the sum is divided by max(l, 1e-20),
// as in `_flash_fwd_chunks`, so a fully masked row reads 0. Key tiles that
// the causal and window masks, or negative key positions (the ring cache
// early in a sequence), cover entirely are never loaded (the Pallas
// kernel's `pl.when(run)`): every launch shape walks only the contiguous
// range of key tiles that `tile_range` finds live. q_off and kv_off are
// runtime ints, so a decode step builds nothing new.
//
// Four launch shapes, chosen by Sq, dtype and D. None falls back to
// another: a launch that fails returns its error and the wrapper raises.
//
// 1. Sq > 1, bfloat16, D <= 128: tensor cores (`hop::flash_wgmma_kernel`).
//    The prefill is bound by bytes on the H100 (q [8, 512, 32, 80] over 512
//    kept keys: 25 us of HBM traffic against 11 us of bf16 tensor-core
//    work), so the design keeps every byte on chip once loaded and the
//    tensor cores fed:
//    - one persistent CTA per SM walks work items (a 128-row query tile
//      of one batch * head), the tiles with the most live key tiles first
//      under the causal mask;
//    - a producer warp issues TMA loads (tensor maps encoded on the host,
//      passed as __grid_constant__ parameters) of each item's Q and of its
//      64-key K and V tiles into a three-stage ring in shared memory, in
//      bf16, 128-byte swizzled, each load completing on an mbarrier; the
//      next item's Q is loaded as soon as the consumers' last Q K^T of the
//      current one is done, so its loads overlap the current item's tail
//      (with one CTA per item, the SM idled while each new CTA waited for
//      its first tiles);
//    - two consumer warpgroups of 64 query rows each run S = Q K^T with
//      wgmma (m64n64k16, Q and K both K-major in shared memory, f32
//      accumulators), mask per accumulator element from runtime ints, do
//      the online softmax in registers (row max and sum across the four
//      lanes of a quad), round P to bf16 in the accumulator layout, which is
//      wgmma's register A-operand layout, and run O += P V with V read from
//      shared memory as an MN-major (transposed) B; each stage is released
//      to the producer on an mbarrier when its P V is done;
//    - the epilogue divides by max(l, 1e-20) and writes bf16.
//    Head dims that are not a multiple of 64: the TMA box is 64 columns
//    (one 128-byte swizzled row) and fills the columns past D with zeros
//    without reading memory, so both products run over D padded to DP =
//    16 (D = 16), 64 (D <= 64), 80 or 128 (the configs' D = 16, 64, 80,
//    120, 128): Q K^T in DP / 16 k-steps, the last ones over the zeros, and
//    P V as N = DP in n16, n64, n64 + n16 or n64 + n64 pieces, each inside
//    one 64-column chunk of V. With Dv < D only V's first ceil(Dv / 64)
//    chunks are loaded; the columns of O past Dv are never written.
// 1b. Sq > 1, bfloat16, D > 128 (MLA: 192 / 128 over a full sequence,
//    576 / 512 in its weight-absorbed prefill): `wide::flash_mma_kernel`.
//    The wgmma kernel cannot hold D = 576 / Dv = 512: one warpgroup's
//    64 x 512 float32 accumulator is 256 registers a thread, and the q, k
//    and v tiles fill about 208 KB of shared memory. So a CTA of four warps
//    takes 64 query rows and 128 or 256 columns of O (a grid dimension
//    walks Dv in such blocks, each recomputing S = Q K^T: at 576 / 512 the
//    products grow 1.5x, the accumulator is 128 registers); Q sits in
//    shared memory, 32-key K and V tiles stream through two cp.async
//    stages (183 KB at D = 576), and both products run as mma.sync
//    m16n8k16 (bf16 in, float32 accumulators) from fragments read out of
//    shared memory, rows padded by 16 bytes so that they hit 32 banks. The
//    online softmax is the wgmma kernel's (the S accumulator layout is
//    the P operand's, p rounded to bf16, l from the float32 p).
// 2. Sq > 1, float32: the FMA kernel (`simt::flash_fma_kernel`). Float32
//    is the parity dtype (lm_parity holds 12 float32 layers against the
//    CPU), and tensor cores would compute it in TF32, about three decimal
//    digits; so a float32 launch keeps the products on the FMA pipes: one
//    block of 128 threads per (16-row query tile, batch * head), 64-key
//    K/V tiles (32 keys past D or Dv = 128) in shared memory, scores and
//    p @ V with fmaf. It is bound by operations (about 7 flops per
//    shared-memory load). A lane holds 4 of every 128 columns of O (Dv <=
//    576 is at most five such pieces).
// 3. Sq == 1, both dtypes: split-KV decode (`dec::flash_split_kernel`,
//    then `dec::flash_merge_kernel`: two launches in one C call). Decode
//    reads the whole K/V cache once for one query row per head and is
//    bound by bytes, so no tensor cores:
//    - one CTA per (batch, kv head, key split) holds the H / Hkv query
//      rows of its kv head (up to 8 a CTA), so K and V are read once per
//      kv head rather than once per query head (MLA's one latent kv head
//      under 128 query heads: 16 CTAs a batch row and split);
//    - the live key range is cut into splits by the wrapper's
//      `decode_split_plan` only as far as B * Hkv * splits covers every SM
//      once: with fewer CTAs than SMs (qwen2.5-3b at B = 1 has 2) the
//      splits put the bytes in flight that one CTA per kv head cannot;
//      with more, each further split only adds scratch traffic and the
//      merge (chip_smoke.py times both sides), and streams through shared
//      memory in its own dtype in
//      a two-stage cp.async ring (the next tile loads while this one is
//      used), of half as many keys past D = 128 (shared memory is sized by
//      the call's D and Dv);
//    - p @ V: up to D = 128 the four warps split the keys of a tile and
//      their sums are added at the end; past it (MLA) they split the
//      columns, 128 each (and 128 more 512 on, to Dv = 640), a choice
//      made at compile time, so that the narrow loop keeps its fixed
//      stride;
//    - each split writes its (m, l, unnormalised acc) to float32 scratch,
//      and the merge takes the log-sum-exp over the splits, its threads
//      looping over the Dv columns. A split with no kept key holds (-1e30,
//      0, 0) and weighs 0 in the merge; with every split empty the row
//      reads 0 / 1e-20 = 0. With one split the split kernel normalises and
//      writes the output itself (no merge).
//
// With an `lse` pointer (training: the backward in flash_attention_bwd.cu
// recomputes p from it) the three Sq > 1 kernels also write each row's
// log-sum-exp m + log(max(l, 1e-20)), natural log, float32 [B, H, Sq]: about
// -1e30 for a row with no kept key, so the backward's p is its mask's 0
// (the mma.sync kernel writes it from the CTA of O's first columns; every
// CTA of a query tile holds the same m and l). A call with `lse` and Sq ==
// 1 takes the Sq > 1 kernels, not the decode. A null `lse` writes nothing
// more: the serving path launches what it did. The lse, like the backward,
// takes D <= 192 (MLA's 192 / 128 over the full sequence) and any Dv <= D.
//
// Head dims: D <= 576 and Dv <= D, both multiples of 8 (the configs use 16,
// 64, 80, 120, 128; MLA 192 / 128 and 576 / 512); the wrapper checks it.
// Tolerance against the plain version: float32 sums in another order, 1e-4
// absolute + 1e-4 relative in float32. In bfloat16 2e-2: the output rounds
// to 8 bits of mantissa, and the tensor-core paths also round p to bf16
// before P V (the Pallas kernel keeps p in float32); l is summed from the
// float32 p.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 576;        // q / k head dim; v's is at most D
constexpr int kMaxTensorCoreD = 128;  // the wgmma route
constexpr int kMaxTrainD = 192;       // the lse (training)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;   // [B, Sq, H, D]
  const void* k;   // [B, Skv, Hkv, D]
  const void* v;   // [B, Skv, Hkv, Dv]
  void* out;       // [B, Sq, H, Dv]
  float* scratch;  // decode with n_splits > 1: [B * H, n_splits, Dv + 2]
  float* lse;      // null, or [B, H, Sq]: each row's log-sum-exp (Sq > 1)
  int b, sq, skv, h, hkv, d, dv;
  float scale;
  int causal, window, q_off, kv_off;
  int key_lo, key_hi, split_len, n_splits;  // decode: the split plan
};

__device__ __forceinline__ bool kept(int row, int col, const FlashArgs& a) {
  bool ok = col >= 0;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && col >= row - a.window + 1;
  return ok;
}

// The key tiles [t0, t1) of width bk that hold a kept key for some query
// position in [row_lo, row_hi]: tiles below position 0, after the causal
// bound or before the window are skipped, and the rest are contiguous.
__device__ __forceinline__ void tile_range(const FlashArgs& a, int row_lo,
                                           int row_hi, int bk, int& t0,
                                           int& t1) {
  int j_min = a.kv_off < 0 ? -a.kv_off : 0;
  if (a.window > 0) j_min = max(j_min, row_lo - a.window + 1 - a.kv_off);
  int j_max = a.skv - 1;
  if (a.causal) j_max = min(j_max, row_hi - a.kv_off);
  if (j_max < j_min) {
    t0 = t1 = 0;
    return;
  }
  t0 = j_min / bk;
  t1 = j_max / bk + 1;
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
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// 16 bytes global -> shared, or 16 zero bytes when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 2. Sq > 1, float32: the FMA kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 16;
constexpr int kRowsPerWarp = BQ / kWarps;            // p @ V rows a warp
constexpr int kWideD = 128;       // past it (D or Dv) the wide instance

constexpr int smem_floats(int d, int dv, int bk) {
  return BQ * d + bk * (d + 4) + bk * (dv + 4) + BQ * bk + 3 * BQ;
}

// BK keys a tile; NCH pieces of 128 columns of O a lane (4 columns each)
template <int BK, int NCH>
__global__ void __launch_bounds__(kThreads) flash_fma_kernel(FlashArgs a) {
  constexpr int kRowsPerGroup = BQ / (kThreads / BK);  // score rows a thread
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, dv = a.dv, ldk = d + 4, ldv = dv + 4;
  const int d4 = d / 4, dv4 = dv / 4;
  float* const qs = smem;                 // [BQ][d]
  float* const ks = qs + BQ * d;          // [BK][ldk]
  float* const vs = ks + BK * ldk;        // [BK][ldv]
  float* const ss = vs + BK * ldv;        // [BQ][BK] scores, then p
  float* const row_m = ss + BQ * BK;      // [BQ]
  float* const row_l = row_m + BQ;        // [BQ]
  float* const row_alpha = row_l + BQ;    // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dv;
  const float* const qb = static_cast<const float*>(a.q) +
                          static_cast<long long>(bi) * a.sq * q_stride +
                          static_cast<long long>(hi) * d;
  const float* const kb = static_cast<const float*>(a.k) +
                          static_cast<long long>(bi) * a.skv * k_stride +
                          static_cast<long long>(hk) * d;
  const float* const vb = static_cast<const float*>(a.v) +
                          static_cast<long long>(bi) * a.skv * v_stride +
                          static_cast<long long>(hk) * dv;

  for (int idx = tid; idx < BQ * d4; idx += kThreads) {
    const int r = idx / d4, c = (idx % d4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.sq) val = load4(qb + (q0 + r) * q_stride + c);
    store4(qs + r * d + c, val);
  }
  if (tid < BQ) {
    row_m[tid] = kNeg;
    row_l[tid] = 0.0f;
  }

  const int pv_row0 = warp * kRowsPerWarp;
  float acc[kRowsPerWarp][NCH][4];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      acc[rr][ch][0] = acc[rr][ch][1] = acc[rr][ch][2] = acc[rr][ch][3] =
          0.0f;

  const int last_row = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  int t0, t1;
  tile_range(a, a.q_off + q0, a.q_off + last_row, BK, t0, t1);

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BK;
    const int jn = a.skv - j0 < BK ? a.skv - j0 : BK;
    __syncthreads();                    // the last tile's readers are done

    for (int idx = tid; idx < BK * d4; idx += kThreads) {
      const int j = idx / d4, c = (idx % d4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < jn) kv = load4(kb + (j0 + j) * k_stride + c);
      store4(ks + j * ldk + c, kv);
    }
    for (int idx = tid; idx < BK * dv4; idx += kThreads) {
      const int j = idx / dv4, c = (idx % dv4) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < jn) vv = load4(vb + (j0 + j) * v_stride + c);
      store4(vs + j * ldv + c, vv);
    }
    __syncthreads();

    {  // scores of key j against kRowsPerGroup query rows
      const int j = tid % BK, r0 = (tid / BK) * kRowsPerGroup;
      float s[kRowsPerGroup];
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r) s[r] = 0.0f;
      const float* kr = ks + j * ldk;
      for (int c = 0; c < d; c += 4) {
        const float4 kk = load4(kr + c);
#pragma unroll
        for (int r = 0; r < kRowsPerGroup; ++r) {
          const float4 qq = load4(qs + (r0 + r) * d + c);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
      const int col = a.kv_off + j0 + j;
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r) {
        const bool ok = j < jn && kept(a.q_off + q0 + r0 + r, col, a);
        ss[(r0 + r) * BK + j] = ok ? s[r] * a.scale : kNeg;
      }
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += kWarps) {  // online softmax, one warp a row
      const int row = a.q_off + q0 + r;
      const float m_prev = row_m[r];
      float mx = m_prev;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ss[r * BK + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const bool ok = j < jn && kept(row, a.kv_off + j0 + j, a);
        const float p = ok ? expf(ss[r * BK + j] - mx) : 0.0f;
        ss[r * BK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, columns 128 ch + 4 lane of this warp's rows
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float al = row_alpha[pv_row0 + rr];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        acc[rr][ch][0] *= al; acc[rr][ch][1] *= al;
        acc[rr][ch][2] *= al; acc[rr][ch][3] *= al;
      }
    }
    for (int j = 0; j < jn; ++j) {
      float p[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        p[rr] = ss[(pv_row0 + rr) * BK + j];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int c4 = 128 * ch + lane * 4;
        if (c4 >= dv) break;
        const float4 vv = load4(vs + j * ldv + c4);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          acc[rr][ch][0] = fmaf(p[rr], vv.x, acc[rr][ch][0]);
          acc[rr][ch][1] = fmaf(p[rr], vv.y, acc[rr][ch][1]);
          acc[rr][ch][2] = fmaf(p[rr], vv.z, acc[rr][ch][2]);
          acc[rr][ch][3] = fmaf(p[rr], vv.w, acc[rr][ch][3]);
        }
      }
    }
  }

  __syncthreads();
  const long long o_stride = static_cast<long long>(a.h) * dv;
  float* const ob = static_cast<float*>(a.out) +
                    static_cast<long long>(bi) * a.sq * o_stride +
                    static_cast<long long>(hi) * dv;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = pv_row0 + rr;
    if (q0 + r >= a.sq) continue;
    const float l = fmaxf(row_l[r], 1e-20f);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int c4 = 128 * ch + lane * 4;
      if (c4 >= dv) break;
      store4(ob + (q0 + r) * o_stride + c4,
             make_float4(acc[rr][ch][0] / l, acc[rr][ch][1] / l,
                         acc[rr][ch][2] / l, acc[rr][ch][3] / l));
    }
  }
  if (a.lse != nullptr && tid < BQ && q0 + tid < a.sq)
    a.lse[(static_cast<long long>(bi) * a.h + hi) * a.sq + q0 + tid] =
        row_m[tid] + logf(fmaxf(row_l[tid], 1e-20f));
}

}  // namespace simt

// ---------------------------------------------------------------------------
// 1. bfloat16, Sq > 1: TMA + wgmma
// ---------------------------------------------------------------------------

namespace hop {

constexpr int BQ = 128;              // query rows a CTA: two warpgroups of 64
constexpr int BK = 64;               // keys a tile
constexpr int kStages = 3;           // K/V ring depth
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRowBytes = 128;       // a 64-column bf16 row, 128B-swizzled

template <int DP>
struct Shape {
  static constexpr int kChunks = (DP + 63) / 64;   // 64-column chunks
  static constexpr int kQBytes = kChunks * BQ * kRowBytes;
  static constexpr int kKVBytes = kChunks * BK * kRowBytes;  // K or V, a stage
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map ({D, heads, rows, batch}, innermost first)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128B-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), swizzle mode
// 1 (128B) in bits 62-63. Tiles sit at 1024-byte aligned addresses, so the
// base offset is 0; a k-step inside a swizzled row advances the start by 32
// bytes, as the hardware applies the swizzle to the address it computes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp, and
// 2^-inf = +0); the tensor-core path's softmax and rescale take it
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma m64nNk16, bf16 in, f32 accumulate. mma_ss: A and B from shared
// memory, both K-major. mma_rs: A from registers (the accumulator layout of
// a 64x16 f32 tile, packed to bf16 pairs), B from shared memory MN-major
// (imm-trans-b = 1). `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


// O += P V for one 16-key step: N = DP columns of V as pieces that each lie
// in one 64-column swizzled chunk (LBO, the chunk stride, is then unused).
template <int DP>
__device__ __forceinline__ void pv_step(float* o, const uint32_t (&p)[4],
                                        uint32_t v_rows) {
  constexpr uint32_t kChunk = BK * kRowBytes;
  static_assert(DP == 16 || DP == 64 || DP == 80 || DP == 128,
                "padded head dim");
  if constexpr (DP == 16) {
    mma_rs_n16(o, p, desc(v_rows, kChunk, 1024), 1);
  } else {
    mma_rs_n64(o, p, desc(v_rows, kChunk, 1024), 1);
    if constexpr (DP == 80)
      mma_rs_n16(o + 32, p, desc(v_rows + kChunk, kChunk, 1024), 1);
    if constexpr (DP == 128)
      mma_rs_n64(o + 32, p, desc(v_rows + kChunk, kChunk, 1024), 1);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, FlashArgs a) {
  using S = Shape<DP>;
  __shared__ __align__(8) uint64_t bars[2 + 3 * kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;
  const uint32_t v_s = k_s + kStages * S::kKVBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_qe = smem_u32(&bars[1]);             // Q read, reload
  const uint32_t bar_k = smem_u32(&bars[2]);              // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[2 + kStages]);
  const uint32_t bar_e = smem_u32(&bars[2 + 2 * kStages]);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // V's 64-column chunks that hold a column < Dv: only those are loaded
  const int v_chunks = (a.dv + 63) / 64;
  // persistent: CTA c takes work items c, c + gridDim.x, ...; item w is
  // query tile n_qt - 1 - w / (B * H) of head w % (B * H), so the tiles
  // with the most keys go first
  const int bh_count = a.b * a.h;
  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int n_items = n_qt * bh_count;
  auto item = [&](int w, int& bi, int& hi, int& q0, int& t0, int& t1) {
    const int bh = w % bh_count;
    bi = bh / a.h;
    hi = bh % a.h;
    q0 = (n_qt - 1 - w / bh_count) * BQ;
    tile_range(a, a.q_off + q0, a.q_off + min(q0 + BQ, a.sq) - 1, BK, t0,
               t1);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, kConsumers / 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {   // the producer warp: one thread issues
    if (lane == 0) {
      int g = 0;                   // K/V tiles issued, over all items
      for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        int bi, hi, q0, t0, t1;
        item(w, bi, hi, q0, t0, t1);
        const int hk = hi / (a.h / a.hkv);
        if (j > 0) mbar_wait(bar_qe, (j - 1) & 1);
        mbar_expect_tx(bar_q, S::kQBytes);
        for (int c = 0; c < S::kChunks; ++c)
          tma_load(q_s + c * BQ * kRowBytes, &tq, bar_q, 64 * c, hi, q0, bi);
        for (int t = t0; t < t1; ++t, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(bar_e + 8 * s, ((g / kStages) - 1) & 1);
          mbar_expect_tx(bar_k + 8 * s, S::kKVBytes);
          for (int c = 0; c < S::kChunks; ++c)
            tma_load(k_s + s * S::kKVBytes + c * BK * kRowBytes, &tk,
                     bar_k + 8 * s, 64 * c, hk, t * BK, bi);
          mbar_expect_tx(bar_v + 8 * s, v_chunks * BK * kRowBytes);
          for (int c = 0; c < v_chunks; ++c)
            tma_load(v_s + s * S::kKVBytes + c * BK * kRowBytes, &tv,
                     bar_v + 8 * s, 64 * c, hk, t * BK, bi);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns query rows [wg * 64, wg * 64 + 64) of
  // the tile; this thread holds rows r_loc and r_loc + 8 of them, at key
  // columns 8 i + 2 (lane % 4) + {0, 1} of each accumulator
  const int wg = warp >> 2;
  const int r_loc = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const float sl2 = a.scale * kLog2e;
  const uint32_t q_rows = q_s + wg * 64 * kRowBytes;
  int g = 0;                       // K/V tiles consumed, over all items
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    int bi, hi, q0, t0, t1;
    item(w, bi, hi, q0, t0, t1);
    const int row0 = a.q_off + q0 + r_loc;
    const int wrow_lo = a.q_off + q0 + wg * 64, wrow_hi = wrow_lo + 63;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(bar_q, j & 1);
    __syncwarp();              // converged again for the .aligned wgmma ops
    if (t0 == t1 && lane == 0) mbar_arrive(bar_qe);   // Q not read at all

    for (int t = t0; t < t1; ++t, ++g) {
      const int s = g % kStages;
      const uint32_t parity = (g / kStages) & 1;
      const uint32_t k_rows = k_s + s * S::kKVBytes;
      const uint32_t v_rows = v_s + s * S::kKVBytes;

      float sc[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.0f;
      mbar_wait(bar_k + 8 * s, parity);
      __syncwarp();
      fence_regs<BK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;   // 16 columns, a swizzled row
        mma_ss_n64(sc,
                   desc(q_rows + (kk >> 2) * BQ * kRowBytes + off, 16, 1024),
                   desc(k_rows + (kk >> 2) * BK * kRowBytes + off, 16, 1024),
                   kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<BK / 2>(sc);
      if (t + 1 == t1) {           // the item's last read of Q
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_qe);
      }

      // scale into log2 units and mask; a kept score is finite, a dropped
      // one -inf, so exp2 sends it to 0 while the running max stays >= -1e30
      const int j0 = t * BK;
      const int col_lo = a.kv_off + j0, col_hi = col_lo + BK - 1;
      const bool whole = col_lo >= 0 && j0 + BK <= a.skv &&
                         (!a.causal || col_hi <= wrow_lo) &&
                         (a.window <= 0 || col_lo >= wrow_hi - a.window + 1);
      if (whole) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= sl2;
      } else {
#pragma unroll
        for (int c8 = 0; c8 < BK / 8; ++c8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * c8 + 2 * (lane & 3) + e;
            const int col = a.kv_off + j;
            const bool in = j < a.skv;
            sc[4 * c8 + e] = in && kept(row0, col, a) ? sc[4 * c8 + e] * sl2
                                                      : -INFINITY;
            sc[4 * c8 + 2 + e] = in && kept(row0 + 8, col, a)
                                     ? sc[4 * c8 + 2 + e] * sl2
                                     : -INFINITY;
          }
        }
      }

      // online softmax over the quad that shares each row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c8 = 0; c8 < BK / 8; ++c8) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * c8], sc[4 * c8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * c8 + 2], sc[4 * c8 + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float al0 = fast_exp2(m0 - mx0), al1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int c8 = 0; c8 < BK / 8; ++c8) {
        sc[4 * c8] = fast_exp2(sc[4 * c8] - m0);
        sc[4 * c8 + 1] = fast_exp2(sc[4 * c8 + 1] - m0);
        sc[4 * c8 + 2] = fast_exp2(sc[4 * c8 + 2] - m1);
        sc[4 * c8 + 3] = fast_exp2(sc[4 * c8 + 3] - m1);
        sum0 += sc[4 * c8] + sc[4 * c8 + 1];
        sum1 += sc[4 * c8 + 2] + sc[4 * c8 + 3];
      }
      l0 = l0 * al0 + sum0;   // this thread's share; the quad sums at the end
      l1 = l1 * al1 + sum1;

      // P as wgmma's A fragments, one per 16-key step
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int c8 = 0; c8 < DP / 8; ++c8) {
        o[4 * c8] *= al0;
        o[4 * c8 + 1] *= al0;
        o[4 * c8 + 2] *= al1;
        o[4 * c8 + 3] *= al1;
      }

      mbar_wait(bar_v + 8 * s, parity);
      __syncwarp();
      fence_regs<DP / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv_step<DP>(o, pf[kk], v_rows + kk * 16 * kRowBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs<DP / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);   // the stage is free
    }

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-20f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-20f);
    const int qr = q0 + r_loc;
    if (a.lse != nullptr && (lane & 3) == 0) {   // m in log2 units
      float* const lb = a.lse + (static_cast<long long>(bi) * a.h + hi) * a.sq;
      if (qr < a.sq) lb[qr] = m0 * kLn2 + logf(fmaxf(l0, 1e-20f));
      if (qr + 8 < a.sq) lb[qr + 8] = m1 * kLn2 + logf(fmaxf(l1, 1e-20f));
    }
    const long long rs = static_cast<long long>(a.h) * a.dv;
    __nv_bfloat16* const ob = static_cast<__nv_bfloat16*>(a.out) +
                              (static_cast<long long>(bi) * a.sq + qr) * rs +
                              static_cast<long long>(hi) * a.dv;
#pragma unroll
    for (int c8 = 0; c8 < DP / 8; ++c8) {
      const int c = 8 * c8 + 2 * (lane & 3);
      if (c >= a.dv) continue;
      if (qr < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + c) =
            __floats2bfloat162_rn(o[4 * c8] * inv0, o[4 * c8 + 1] * inv0);
      if (qr + 8 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * rs + c) =
            __floats2bfloat162_rn(o[4 * c8 + 2] * inv1, o[4 * c8 + 3] * inv1);
    }
  }
}

}  // namespace hop

// ---------------------------------------------------------------------------
// 1b. bfloat16, Sq > 1, D > 128: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace wide {

constexpr int kThreads = 128;        // four warps of 16 query rows
constexpr int BQ = 64;
constexpr int BK = 32;               // keys a tile, two cp.async stages
constexpr int kPad = 8;              // bf16 a shared row past its width

__host__ __device__ constexpr int padded_d(int d) { return (d + 15) / 16 * 16; }

// Q [BQ][DP + 8], then two stages of K [BK][DP + 8] and V [BK][DVT + 8]
__host__ __device__ constexpr int smem_bytes(int d, int dvt) {
  return 2 * (BQ * (padded_d(d) + kPad) +
              2 * BK * (padded_d(d) + kPad) + 2 * BK * (dvt + kPad));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA per (64-row query tile, batch * head, DVT columns of O). Warp w
// holds rows 16 w .. 16 w + 15; this thread rows g and g + 8 of them (g =
// lane / 4), at key / column pairs 2 t, 2 t + 1 of each 8-wide n-tile (t =
// lane % 4), the m16n8k16 accumulator layout.
template <int DVT>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(FlashArgs a) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int d = a.d, dp = padded_d(d), ldq = dp + kPad, ldv = DVT + kPad;
  __nv_bfloat16* const qs = sm;                         // [BQ][ldq]
  __nv_bfloat16* const ks = qs + BQ * ldq;              // [2][BK][ldq]
  __nv_bfloat16* const vs = ks + 2 * BK * ldq;          // [2][BK][ldv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.z * DVT;
  const __nv_bfloat16* const qg = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* const kg = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* const vg = static_cast<const __nv_bfloat16*>(a.v);

  const int cq = dp / 8, cv = DVT / 8;                   // 16-byte chunks
  for (int idx = tid; idx < BQ * cq; idx += kThreads) {
    const int r = idx / cq, c = (idx % cq) * 8;
    const bool ok = q0 + r < a.sq && c < d;
    const long long off =
        ok ? ((static_cast<long long>(bi) * a.sq + q0 + r) * a.h + hi) * d + c
           : 0;
    cp_async16(qs + r * ldq + c, qg + off, ok);
  }
  auto load_tile = [&](int tile, int stage) {
    const int j0 = tile * BK;
    for (int idx = tid; idx < BK * cq; idx += kThreads) {
      const int r = idx / cq, c = (idx % cq) * 8;
      const bool ok = j0 + r < a.skv && c < d;
      const long long off =
          ok ? ((static_cast<long long>(bi) * a.skv + j0 + r) * a.hkv + hk) *
                       d + c
             : 0;
      cp_async16(ks + (stage * BK + r) * ldq + c, kg + off, ok);
    }
    for (int idx = tid; idx < BK * cv; idx += kThreads) {
      const int r = idx / cv, c = (idx % cv) * 8;
      const bool ok = j0 + r < a.skv && c0 + c < a.dv;
      const long long off =
          ok ? ((static_cast<long long>(bi) * a.skv + j0 + r) * a.hkv + hk) *
                       a.dv + c0 + c
             : 0;
      cp_async16(vs + (stage * BK + r) * ldv + c, vg + off, ok);
    }
  };

  const int last_row = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  int t0, t1;
  tile_range(a, a.q_off + q0, a.q_off + last_row, BK, t0, t1);
  if (t0 < t1) load_tile(t0, 0);
  cp_async_commit();

  const int row0 = a.q_off + q0 + warp * 16 + g;         // and row0 + 8
  const float sl2 = a.scale * kLog2e;
  const __nv_bfloat16* const qw = qs + (warp * 16 + g) * ldq + 2 * t4;
  float o[DVT / 8][4];
#pragma unroll
  for (int n = 0; n < DVT / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  for (int tile = t0; tile < t1; ++tile) {
    const int stage = (tile - t0) & 1;
    cp_async_wait_all();
    __syncthreads();            // tile `tile` has landed; tile - 1 is read
    if (tile + 1 < t1) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const __nv_bfloat16* const kt = ks + stage * BK * ldq;
    const __nv_bfloat16* const vt = vs + stage * BK * ldv;

    float sc[BK / 8][4];        // S = Q K^T, four 8-key n-tiles
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    for (int k0 = 0; k0 < dp; k0 += 16) {
      const uint32_t qa[4] = {ld32(qw + k0), ld32(qw + 8 * ldq + k0),
                              ld32(qw + k0 + 8), ld32(qw + 8 * ldq + k0 + 8)};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* const kr = kt + (n * 8 + g) * ldq + k0 + 2 * t4;
        mma16816(sc[n], qa, ld32(kr), ld32(kr + 8));
      }
    }

    // scale into log2 units and mask: a dropped score is -inf, so exp2
    // sends it to 0 while the running max stays >= -1e30
    const int j0 = tile * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + n * 8 + 2 * t4 + e, col = a.kv_off + j;
        const bool in = j < a.skv;
        sc[n][e] = in && kept(row0, col, a) ? sc[n][e] * sl2 : -INFINITY;
        sc[n][2 + e] =
            in && kept(row0 + 8, col, a) ? sc[n][2 + e] * sl2 : -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - m0);
      sc[n][1] = exp2f(sc[n][1] - m0);
      sc[n][2] = exp2f(sc[n][2] - m1);
      sc[n][3] = exp2f(sc[n][3] - m1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * al0 + sum0;     // this thread's share; the quad sums at the end
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < DVT / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0; o[n][2] *= al1; o[n][3] *= al1;
    }

    // O += P V: P rounded to bf16 in the accumulator layout, which is the
    // A operand's; V's pairs of keys packed from shared memory
#pragma unroll
    for (int ks2 = 0; ks2 < BK / 16; ++ks2) {
      const float* const lo = sc[2 * ks2];         // keys 16 ks2 + 0..7
      const float* const hi8 = sc[2 * ks2 + 1];    // and 8..15
      const uint32_t pa[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                              pack_bf16(hi8[0], hi8[1]),
                              pack_bf16(hi8[2], hi8[3])};
      const __nv_bfloat16* const vr = vt + (ks2 * 16 + 2 * t4) * ldv + g;
#pragma unroll
      for (int n = 0; n < DVT / 8; ++n) {
        const __nv_bfloat16* const v = vr + n * 8;
        mma16816(o[n], pa, pack2(v[0], v[ldv]), pack2(v[8 * ldv], v[9 * ldv]));
      }
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
  const int qr = q0 + warp * 16 + g;
  if (a.lse != nullptr && blockIdx.z == 0 && t4 == 0) {   // m in log2 units
    float* const lb = a.lse + (static_cast<long long>(bi) * a.h + hi) * a.sq;
    if (qr < a.sq) lb[qr] = m0 * kLn2 + logf(fmaxf(l0, 1e-20f));
    if (qr + 8 < a.sq) lb[qr + 8] = m1 * kLn2 + logf(fmaxf(l1, 1e-20f));
  }
  const long long rs = static_cast<long long>(a.h) * a.dv;
  __nv_bfloat16* const ob = static_cast<__nv_bfloat16*>(a.out) +
                            (static_cast<long long>(bi) * a.sq + qr) * rs +
                            static_cast<long long>(hi) * a.dv + c0;
#pragma unroll
  for (int n = 0; n < DVT / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c0 + c >= a.dv) break;
    if (qr < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + c) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (qr + 8 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * rs + c) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace wide

// ---------------------------------------------------------------------------
// 3. Sq == 1: split-KV decode, then the log-sum-exp merge
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;     // query rows (heads of one kv head) a CTA
// Two instances a dtype and row count. Narrow (D <= kNarrowD): keys a tile
// 16 KB or less of K and of V at D = 128 in either dtype, and the four
// warps split each tile's keys in p @ V, a lane 4 of its 128 columns. Wide
// (D > kNarrowD: MLA's 576 / 512): half as many keys a tile, so that the
// ring fits, and the warps split the columns instead, 128 each, a lane 4
// of them and 4 more 512 columns on (Dv <= 640). The wrapper's
// `decode_tile` repeats the tile sizes.
constexpr int kNarrowD = 128;
template <typename T>
__host__ __device__ constexpr int tile_keys(bool wide) {
  return (sizeof(T) == 2 ? 64 : 32) / (wide ? 2 : 1);
}

template <typename T>
__host__ __device__ constexpr int pitch_bytes(int d) {
  return d * static_cast<int>(sizeof(T)) + 16;
}

// K and V, two stages each, then q [GR][d], p [GR][BK], m, l, alpha [GR]
template <typename T, int GR, bool WIDE>
__host__ __device__ constexpr int smem_bytes(int d, int dv) {
  constexpr int BK = tile_keys<T>(WIDE);
  return 2 * BK * (pitch_bytes<T>(d) + pitch_bytes<T>(dv)) +
         4 * (GR * d + GR * BK + 3 * GR);
}

// eight values of a shared-memory row as float
__device__ __forceinline__ void load8(const uint8_t* p, float* f, float) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const uint8_t* p, float* f,
                                      __nv_bfloat16) {
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
// four values
__device__ __forceinline__ float4 load4s(const uint8_t* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4s(const uint8_t* p, __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

// One CTA per (key split, batch * kv head * row group): rows g0 .. g0 + GR
// of the kv head's H / Hkv query heads, keys [j_begin, j_end) of the split.
template <typename T, int GR, bool WIDE>
__global__ void __launch_bounds__(kThreads) flash_split_kernel(FlashArgs a) {
  constexpr int BK = tile_keys<T>(WIDE);
  constexpr int TPK = kThreads / BK;          // threads a key's dot product
  // p @ V: kGroups groups of warps each own 128 columns (and, wide, the
  // 128 columns 512 further on); the kStep warps of a group split the keys
  constexpr int kGroups = WIDE ? kWarps : 1, kStep = kWarps / kGroups;
  constexpr int kPieces = WIDE ? 2 : 1;
  extern __shared__ float4 smem4[];
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem4);
  const int d = a.d, dv = a.dv;
  const int pk = pitch_bytes<T>(d), pv = pitch_bytes<T>(dv);
  const int tile_k = BK * pk, tile_v = BK * pv;
  uint8_t* const ks = sm;                      // [2][BK][pk]
  uint8_t* const vs = ks + 2 * tile_k;         // [2][BK][pv]
  float* const qs = reinterpret_cast<float*>(vs + 2 * tile_v);  // [GR][d]
  float* const ps = qs + GR * d;               // [GR][BK] scores, then p
  float* const st_m = ps + GR * BK;
  float* const st_l = st_m + GR;
  float* const st_a = st_l + GR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = a.h / a.hkv;
  const int n_rg = (group + GR - 1) / GR;
  const int rg = blockIdx.y % n_rg, bkv = blockIdx.y / n_rg;
  const int hk = bkv % a.hkv, bi = bkv / a.hkv;
  const int g0 = rg * GR, gr = min(GR, group - g0);
  const int h0 = hk * group + g0;              // first query head here
  const int split = blockIdx.x;
  const int j_begin = a.key_lo + split * a.split_len;
  const int j_end = min(a.key_hi, j_begin + a.split_len);
  const int n_tiles = j_end > j_begin ? (j_end - j_begin + BK - 1) / BK : 0;

  const T* const qb = static_cast<const T*>(a.q) +
                      (static_cast<long long>(bi) * a.h + h0) * d;
  for (int idx = tid; idx < GR * d; idx += kThreads) {
    const int r = idx / d;
    qs[idx] = r < gr ? to_float(qb[idx]) : 0.0f;
  }
  if (tid < GR) {
    st_m[tid] = kNeg;
    st_l[tid] = 0.0f;
  }

  const long long k_stride = static_cast<long long>(a.hkv) * d;
  const long long v_stride = static_cast<long long>(a.hkv) * dv;
  const T* const kb = static_cast<const T*>(a.k) +
                      (static_cast<long long>(bi) * a.skv * a.hkv + hk) * d;
  const T* const vb = static_cast<const T*>(a.v) +
                      (static_cast<long long>(bi) * a.skv * a.hkv + hk) * dv;
  // 16-byte copies a key: K's cpr_k, V's the first cpr_v of them (Dv <= D)
  const int cpr_k = d * static_cast<int>(sizeof(T)) / 16;
  const int cpr_v = dv * static_cast<int>(sizeof(T)) / 16;
  auto load_tile = [&](int t, int stage) {
    const int j0 = j_begin + t * BK;
    for (int idx = tid; idx < BK * cpr_k; idx += kThreads) {
      const int r = idx / cpr_k, c = idx % cpr_k;
      const bool ok = j0 + r < j_end;         // past the split: zero-filled
      const long long row = ok ? j0 + r : 0;
      cp_async16(ks + stage * tile_k + r * pk + c * 16,
                 reinterpret_cast<const uint8_t*>(kb + row * k_stride) +
                     c * 16, ok);
      if (c < cpr_v)
        cp_async16(vs + stage * tile_v + r * pv + c * 16,
                   reinterpret_cast<const uint8_t*>(vb + row * v_stride) +
                       c * 16, ok);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  const int kpart = warp / kGroups;
  const int c_lo = (warp % kGroups) * 128 + lane * 4;
  const bool live = c_lo < dv;                // this lane holds columns
  float acc[GR][kPieces][4];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int i = 0; i < kPieces; ++i)
      acc[r][i][0] = acc[r][i][1] = acc[r][i][2] = acc[r][i][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();      // this thread's copies of tile t have landed
    __syncthreads();          // everyone's have; tile t - 1 is read
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    cp_async_commit();
    const int j0 = j_begin + t * BK;

    {  // scores: TPK threads a key, over interleaved 8-column chunks
      const int j = tid / TPK, part = tid % TPK;
      const uint8_t* const kr = ks + stage * tile_k + j * pk;
      float s[GR];
#pragma unroll
      for (int r = 0; r < GR; ++r) s[r] = 0.0f;
      for (int c = part; c < d / 8; c += TPK) {
        float kf[8];
        load8(kr + c * 8 * static_cast<int>(sizeof(T)), kf, T());
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const float4 qa = load4(qs + r * d + 8 * c);
          const float4 qc = load4(qs + r * d + 8 * c + 4);
          s[r] = fmaf(qa.x, kf[0], s[r]); s[r] = fmaf(qa.y, kf[1], s[r]);
          s[r] = fmaf(qa.z, kf[2], s[r]); s[r] = fmaf(qa.w, kf[3], s[r]);
          s[r] = fmaf(qc.x, kf[4], s[r]); s[r] = fmaf(qc.y, kf[5], s[r]);
          s[r] = fmaf(qc.z, kf[6], s[r]); s[r] = fmaf(qc.w, kf[7], s[r]);
        }
      }
#pragma unroll
      for (int x = 1; x < TPK; x <<= 1)
#pragma unroll
        for (int r = 0; r < GR; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], x);
      if (part == 0) {
        const bool ok = j0 + j < j_end && kept(a.q_off, a.kv_off + j0 + j, a);
#pragma unroll
        for (int r = 0; r < GR; ++r)
          ps[r * BK + j] = ok ? s[r] * sl2 : -INFINITY;
      }
    }
    __syncthreads();

    for (int r = warp; r < GR; r += kWarps) {  // online softmax, a warp a row
      const float m_prev = st_m[r];
      float mx = m_prev;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[r * BK + j]);
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float p = exp2f(ps[r * BK + j] - mx);
        ps[r * BK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - mx);
        st_a[r] = alpha;
        st_l[r] = st_l[r] * alpha + sum;
        st_m[r] = mx;
      }
    }
    __syncthreads();

    if (live) {  // acc = acc * alpha + p @ V over this warp's keys, columns
      const uint8_t* const vt =
          vs + stage * tile_v + c_lo * static_cast<int>(sizeof(T));
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        const float al = st_a[r];
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          acc[r][i][0] *= al; acc[r][i][1] *= al;
          acc[r][i][2] *= al; acc[r][i][3] *= al;
        }
      }
      for (int j = kpart; j < BK; j += kStep) {
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          if (i > 0 && c_lo + 512 * i >= dv) break;
          const float4 vv = load4s(
              vt + j * pv + 512 * i * static_cast<int>(sizeof(T)), T());
#pragma unroll
          for (int r = 0; r < GR; ++r) {
            const float p = ps[r * BK + j];
            acc[r][i][0] = fmaf(p, vv.x, acc[r][i][0]);
            acc[r][i][1] = fmaf(p, vv.y, acc[r][i][1]);
            acc[r][i][2] = fmaf(p, vv.z, acc[r][i][2]);
            acc[r][i][3] = fmaf(p, vv.w, acc[r][i][3]);
          }
        }
      }
    }
  }

  // add the key-splitting warps' partial sums (over the K/V stages, now
  // idle: [kStep][GR][dv] floats, at most 128 * Dv bytes)
  cp_async_wait_all();
  __syncthreads();
  float* const red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int c4 = c_lo + 512 * i;
    if (c4 >= dv) break;
#pragma unroll
    for (int r = 0; r < GR; ++r)
      store4(red + (kpart * GR + r) * dv + c4,
             make_float4(acc[r][i][0], acc[r][i][1], acc[r][i][2],
                         acc[r][i][3]));
  }
  __syncthreads();
  for (int idx = tid; idx < gr * dv; idx += kThreads) {
    const int r = idx / dv, c = idx % dv;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kStep; ++w) sum += red[(w * GR + r) * dv + c];
    const long long row = static_cast<long long>(bi) * a.h + h0 + r;
    if (a.n_splits == 1) {
      from_float(static_cast<T*>(a.out) + row * dv + c,
                 sum / fmaxf(st_l[r], 1e-20f));
    } else {
      float* const sc = a.scratch + (row * a.n_splits + split) * (dv + 2);
      sc[c] = sum;
      if (c == 0) {
        sc[dv] = st_m[r];
        sc[dv + 1] = st_l[r];
      }
    }
  }
}

// One block per (batch, head) row: out = sum_s 2^(m_s - M) acc_s over
// max(sum_s 2^(m_s - M) l_s, 1e-20), M the largest m_s (log2 units); the
// block's threads loop over the Dv columns.
constexpr int kMergeThreads = 128;
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    flash_merge_kernel(FlashArgs a) {
  const long long row = blockIdx.x;
  const int dv = a.dv, stride = dv + 2;
  const float* const base = a.scratch + row * a.n_splits * stride;
  float mx = kNeg;
  for (int s = 0; s < a.n_splits; ++s) mx = fmaxf(mx, base[s * stride + dv]);
  for (int c = threadIdx.x; c < dv; c += kMergeThreads) {
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < a.n_splits; ++s) {
      const float w = exp2f(base[s * stride + dv] - mx);
      den += w * base[s * stride + dv + 1];
      num += w * base[s * stride + c];
    }
    from_float(static_cast<T*>(a.out) + row * dv + c,
               num / fmaxf(den, 1e-20f));
  }
}

}  // namespace dec

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime (the
// library links no libcuda), once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, rows, heads, d] tensor as a 4-D map, boxes of 64 columns x
// one head x box_rows rows, 128B-swizzled; columns past d and rows past
// `rows` read as zeros. Returns 0 or -CUresult (-1000 with no encoder).
int encode(CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
           int d, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;   // the opt-in above 48 KB, once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DP>
int launch_hopper(const FlashArgs& a, cudaStream_t stream) {
  using S = hop::Shape<DP>;
  static bool configured = false;
  cudaError_t err =
      allow_smem(hop::flash_wgmma_kernel<DP>, S::kSmem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, a.q, a.b, a.sq, a.h, a.d, hop::BQ);
  if (rc == 0) rc = encode(&tk, a.k, a.b, a.skv, a.hkv, a.d, hop::BK);
  if (rc == 0) rc = encode(&tv, a.v, a.b, a.skv, a.hkv, a.dv, hop::BK);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;      // one persistent CTA per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = a.b * a.h * ((a.sq + hop::BQ - 1) / hop::BQ);
  const dim3 grid(items < sms ? items : sms);
  hop::flash_wgmma_kernel<DP>
      <<<grid, hop::kThreads, S::kSmem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hopper(const FlashArgs& a, cudaStream_t stream) {
  if (a.d <= 16) return launch_hopper<16>(a, stream);
  if (a.d <= 64) return launch_hopper<64>(a, stream);
  if (a.d <= 80) return launch_hopper<80>(a, stream);
  return launch_hopper<128>(a, stream);
}

// the FMA kernel's instance: 64-key tiles and one 128-column piece of O a
// lane up to D = Dv = 128, else 32-key tiles and five pieces (Dv <= 640)
template <int BK, int NCH>
int launch_fma(const FlashArgs& a, int max_d, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err = allow_smem(
      simt::flash_fma_kernel<BK, NCH>,
      simt::smem_floats(max_d, max_d, BK) * static_cast<int>(sizeof(float)),
      configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + simt::BQ - 1) / simt::BQ, a.b * a.h);
  const size_t bytes = simt::smem_floats(a.d, a.dv, BK) * sizeof(float);
  simt::flash_fma_kernel<BK, NCH>
      <<<grid, simt::kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 past D = 128: DVT columns of O a CTA, ceil(Dv / DVT) CTAs a
// query tile
template <int DVT>
int launch_wide(const FlashArgs& a, cudaStream_t stream) {
  static bool configured = false;
  const int bytes = wide::smem_bytes(kMaxD, DVT);
  const cudaError_t err =
      allow_smem(wide::flash_mma_kernel<DVT>, bytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + wide::BQ - 1) / wide::BQ, a.b * a.h,
                  (a.dv + DVT - 1) / DVT);
  wide::flash_mma_kernel<DVT><<<grid, wide::kThreads,
                                wide::smem_bytes(a.d, DVT), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Sq > 1: bfloat16 on the tensor cores (wgmma up to D = 128, mma.sync
// past it), float32 on the FMA pipes (the header says why)
int dispatch_rows(const FlashArgs& a, int dtype, cudaStream_t stream) {
  constexpr int kW = simt::kWideD;
  if (dtype == 1) {
    if (a.d <= kMaxTensorCoreD) return dispatch_hopper(a, stream);
    return a.dv <= 128 ? launch_wide<128>(a, stream)
                       : launch_wide<256>(a, stream);
  }
  if (a.d <= kW && a.dv <= kW) return launch_fma<64, 1>(a, kW, stream);
  return launch_fma<32, 5>(a, kMaxD, stream);
}

template <typename T, int GR, bool WIDE>
int launch_decode(const FlashArgs& a, cudaStream_t stream) {
  static bool configured = false;
  const int max_d = WIDE ? kMaxD : dec::kNarrowD;
  cudaError_t err =
      allow_smem(dec::flash_split_kernel<T, GR, WIDE>,
                 dec::smem_bytes<T, GR, WIDE>(max_d, max_d), configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = a.h / a.hkv;
  const dim3 grid(a.n_splits, a.b * a.hkv * ((group + GR - 1) / GR));
  dec::flash_split_kernel<T, GR, WIDE>
      <<<grid, dec::kThreads, dec::smem_bytes<T, GR, WIDE>(a.d, a.dv),
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return static_cast<int>(err);
  dec::flash_merge_kernel<T><<<a.b * a.h, dec::kMergeThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GR>
int dispatch_decode_tile(const FlashArgs& a, cudaStream_t stream) {
  return a.d <= dec::kNarrowD ? launch_decode<T, GR, false>(a, stream)
                              : launch_decode<T, GR, true>(a, stream);
}

template <typename T>
int dispatch_decode(const FlashArgs& a, cudaStream_t stream) {
  const int group = a.h / a.hkv;
  if (group <= 1) return dispatch_decode_tile<T, 1>(a, stream);
  if (group <= 2) return dispatch_decode_tile<T, 2>(a, stream);
  if (group <= 4) return dispatch_decode_tile<T, 4>(a, stream);
  return dispatch_decode_tile<T, dec::kMaxRows>(a, stream);
}

}  // namespace

extern "C" {

// One call. dtype 0: float32 q, k, v, out; 1: bfloat16. All four are
// contiguous and 16-byte aligned; D % 8 == 0, D <= 576, Dv % 8 == 0, Dv <=
// D, H % Hkv == 0, B * H <= 65535 (the wrapper checks each). q and k are D
// wide, v and out Dv. With Sq == 1, the split plan (key_lo, key_hi,
// split_len, n_splits) cuts the live keys into splits and `scratch` holds
// B * H * n_splits * (Dv + 2) floats when n_splits > 1. Returns 0, a
// cudaError_t, or -CUresult when a TMA descriptor could not be encoded
// (-1000: no cuTensorMapEncodeTiled entry point was found).
// `lse`: null, or [B, H, Sq] float32 for each row's log-sum-exp (D <= 192);
// with it Sq == 1 takes the Sq > 1 kernels, and with Skv == 0 it is not
// written.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* scratch, void* lse, int dtype, int b, int sq,
                    int skv, int h, int hkv, int d, int dv, float scale,
                    int causal, int window, int q_off, int kv_off,
                    int key_lo, int key_hi, int split_len, int n_splits,
                    void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (d <= 0 || d > kMaxD || d % 8 != 0 || dv <= 0 || dv > d ||
      dv % 8 != 0 || hkv <= 0 || h % hkv != 0 || skv < 0 ||
      (lse != nullptr && d > kMaxTrainD))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 1 ? 2 : 4;
  if (skv == 0)   // no key at all: every row reads 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(b) * sq * h * dv * elem, s));
  const FlashArgs a{q, k, v, out, static_cast<float*>(scratch),
                    static_cast<float*>(lse), b, sq, skv, h, hkv, d, dv,
                    scale, causal, window, q_off, kv_off, key_lo, key_hi,
                    split_len, n_splits};
  if (sq == 1 && lse == nullptr) {
    if (n_splits < 1 || (n_splits > 1 && (scratch == nullptr ||
                                           split_len <= 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 1 ? dispatch_decode<__nv_bfloat16>(a, s)
                      : dispatch_decode<float>(a, s);
  }
  return dispatch_rows(a, dtype, s);
}

}  // extern "C"
