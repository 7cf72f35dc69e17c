// Streaming-softmax (flash) attention for Hopper (sm_90a), float32 or
// bfloat16 in and out, float32 inside.
//
// Replaces the TPU kernel `flash_attention_pallas` (`_flash_kernel`) in
// src/repro/kernels/flash_attention.py. It computes the function of
// `blockwise_attention` (src/repro/models/layers.py), of which the Pallas
// kernel is the case H == Hkv, kv_offset == 0 in a [B, H, S, D] layout;
// semantics are those of `flash_attention_ref` (src/repro_torch/kernels/
// ref.py). Over the model's layout q [B, Sq, H, D], k / v [B, Skv, Hkv, D]:
//
//   row i of q sits at position q_off + i, key j at position kv_off + j;
//   (i, j) is kept when 0 <= kv_off + j, and, if causal, kv_off + j <= q_off
//   + i, and, with window > 0, kv_off + j >= q_off + i - window + 1;
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / (H / Hkv)]
//                  over the kept j) @ v[b, :, h / (H / Hkv)],
//   and 0 for a row with no kept key (not NaN).
//
// The running max starts at -1e30 and the sum is divided by max(l, 1e-20),
// as in `_flash_fwd_chunks`, so a fully masked row reads 0.
//
// Design. One block of 128 threads per (query tile, batch * head). The Pallas
// kernel walks the key tiles as its innermost, sequential grid axis with the
// (m, l, acc) carry in VMEM; here the block loops over key tiles itself:
//   1. the tile's K and V rows go to shared memory as float32 (16-byte loads;
//      rows padded to D + 4 floats, so the lanes' float4 reads of 32
//      different rows fall in different banks);
//   2. scores: each thread takes one key and BQ / groups query rows, dot
//      products over D from shared memory into a [BQ, BK] score tile;
//   3. one warp per query row takes the tile's max, exponentiates, sums, and
//      updates (m, l) and the rescale factor alpha;
//   4. each lane owns four of the D output columns of its warp's rows and
//      adds p @ V into float32 registers.
// Key tiles that the causal and window masks cover entirely are skipped
// (the Pallas kernel's `pl.when(run)`), and so are tiles wholly at negative
// positions, which the sliding-window ring cache gives early in a sequence.
// q_off and kv_off are runtime ints, so a decode step builds nothing new.
//
// Two launch shapes. A prefill tile is 16 query rows over 64 keys. A decode
// step has one query row: a 16-row tile would idle 15 rows, so decode takes
// one row over 128-key tiles, its four warps each summing a quarter of every
// tile's keys into their own partial accumulators, added at the end (alpha
// scales them alike).
//
// What bounds it on the H100: the products run on the FMA pipes in float32
// (no tensor cores), so at prefill (q [8, 512, 32, 80] over 576 keys) it is
// bound by operations, about 7 of the 2 * 2 * Sq * Skv / 2 * D causal flops
// per shared-memory load; at decode it reads the whole K/V cache once and
// is bound by bytes. The tensor-core form (wgmma over bf16 tiles with the
// softmax in registers) is later work.
//
// Head dims: any D <= 128 with D % 8 == 0 (the configs use 16, 64, 80, 120,
// 128); the wrapper checks it. Tolerance against the plain version: float32
// sums in another order, 1e-4 absolute + 1e-4 relative in float32; in
// bfloat16 the output rounds to 8 bits of mantissa, 2e-2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

struct FlashArgs {
  const void* q;   // [B, Sq, H, D]
  const void* k;   // [B, Skv, Hkv, D]
  const void* v;   // [B, Skv, Hkv, D]
  void* out;       // [B, Sq, H, D]
  int b, sq, skv, h, hkv, d;
  float scale;
  int causal, window, q_off, kv_off;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ bool kept(int row, int col, const FlashArgs& a) {
  bool ok = col >= 0;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && col >= row - a.window + 1;
  return ok;
}

template <int BQ, int BK>
constexpr int smem_floats(int d) {
  return BQ * d + 2 * BK * (d + 4) + BQ * BK + 3 * BQ;
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  // query rows per score-phase thread group, and the decode split
  constexpr int kGroups = kThreads / BK;
  constexpr int kRowsPerGroup = BQ / kGroups > 0 ? BQ / kGroups : 1;
  static_assert(kGroups * kRowsPerGroup == BQ || (BQ == 1 && kGroups == 1),
                "score tile must cover the query tile");
  constexpr int kRowsPerWarp = BQ >= kWarps ? BQ / kWarps : 1;
  constexpr int kSplit = BQ >= kWarps ? 1 : kWarps / BQ;

  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, ld = d + 4, d4 = d / 4;
  float* const qs = smem;                 // [BQ][d]
  float* const ks = qs + BQ * d;          // [BK][ld]
  float* const vs = ks + BK * ld;         // [BK][ld]
  float* const ss = vs + BK * ld;         // [BQ][BK] scores, then p
  float* const row_m = ss + BQ * BK;      // [BQ]
  float* const row_l = row_m + BQ;        // [BQ]
  float* const row_alpha = row_l + BQ;    // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long kv_stride = static_cast<long long>(a.hkv) * d;
  const T* const qb = static_cast<const T*>(a.q) +
                      static_cast<long long>(bi) * a.sq * q_stride +
                      static_cast<long long>(hi) * d;
  const long long kv_base = static_cast<long long>(bi) * a.skv * kv_stride +
                            static_cast<long long>(hk) * d;
  const T* const kb = static_cast<const T*>(a.k) + kv_base;
  const T* const vb = static_cast<const T*>(a.v) + kv_base;

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

  const int pv_row0 = (warp / kSplit) * kRowsPerWarp;
  const int pv_part = warp % kSplit;
  const int c4 = lane * 4;
  const bool lane_live = c4 < d;
  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
    acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0.0f;

  const int last_row = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  const int row_lo = a.q_off + q0, row_hi = a.q_off + last_row;

  for (int j0 = 0; j0 < a.skv; j0 += BK) {
    const int jn = a.skv - j0 < BK ? a.skv - j0 : BK;
    const int col_lo = a.kv_off + j0, col_hi = a.kv_off + j0 + jn - 1;
    bool skip = col_hi < 0;
    if (a.causal) skip = skip || col_lo > row_hi;
    if (a.window > 0) skip = skip || col_hi < row_lo - a.window + 1;
    if (skip) continue;                 // the same for every thread
    __syncthreads();                    // the last tile's readers are done

    for (int idx = tid; idx < BK * d4; idx += kThreads) {
      const int j = idx / d4, c = (idx % d4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < jn) {
        kv = load4(kb + (j0 + j) * kv_stride + c);
        vv = load4(vb + (j0 + j) * kv_stride + c);
      }
      store4(ks + j * ld + c, kv);
      store4(vs + j * ld + c, vv);
    }
    __syncthreads();

    {  // scores of key j against kRowsPerGroup query rows
      const int j = tid % BK, r0 = (tid / BK) * kRowsPerGroup;
      if (r0 < BQ) {
        float s[kRowsPerGroup];
#pragma unroll
        for (int r = 0; r < kRowsPerGroup; ++r) s[r] = 0.0f;
        const float* kr = ks + j * ld;
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

    if (lane_live) {  // acc = acc * alpha + p @ V over this warp's keys
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float al = row_alpha[pv_row0 + rr];
        acc[rr][0] *= al; acc[rr][1] *= al; acc[rr][2] *= al; acc[rr][3] *= al;
      }
      for (int j = pv_part; j < jn; j += kSplit) {
        const float4 vv = load4(vs + j * ld + c4);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float p = ss[(pv_row0 + rr) * BK + j];
          acc[rr][0] = fmaf(p, vv.x, acc[rr][0]);
          acc[rr][1] = fmaf(p, vv.y, acc[rr][1]);
          acc[rr][2] = fmaf(p, vv.z, acc[rr][2]);
          acc[rr][3] = fmaf(p, vv.w, acc[rr][3]);
        }
      }
    }
  }

  if (kSplit > 1) {  // add the warps' partial sums of the same rows
    __syncthreads();
    if (lane_live) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        store4(ks + (warp * kRowsPerWarp + rr) * ld + c4,
               make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]));
    }
    __syncthreads();
    if (pv_part == 0 && lane_live) {
      for (int part = 1; part < kSplit; ++part) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float4 o = load4(ks + ((warp + part) * kRowsPerWarp + rr) * ld + c4);
          acc[rr][0] += o.x; acc[rr][1] += o.y; acc[rr][2] += o.z; acc[rr][3] += o.w;
        }
      }
    }
  }
  __syncthreads();
  if (pv_part == 0 && lane_live) {
    T* const ob = static_cast<T*>(a.out) +
                  static_cast<long long>(bi) * a.sq * q_stride +
                  static_cast<long long>(hi) * d;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = pv_row0 + rr;
      if (q0 + r >= a.sq) continue;
      const float l = fmaxf(row_l[r], 1e-20f);
      store4(ob + (q0 + r) * q_stride + c4,
             make_float4(acc[rr][0] / l, acc[rr][1] / l, acc[rr][2] / l,
                         acc[rr][3] / l));
    }
  }
}

template <typename T, int BQ, int BK>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  static bool configured = false;   // the opt-in above 48 KB, once per shape
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats<BQ, BK>(kMaxD) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.h);
  const size_t bytes = smem_floats<BQ, BK>(a.d) * sizeof(float);
  flash_kernel<T, BQ, BK><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashArgs& a, cudaStream_t stream) {
  if (a.sq == 1) return launch<T, 1, 128>(a, stream);
  return launch<T, 16, 64>(a, stream);
}

}  // namespace

extern "C" {

// One launch. dtype 0: float32 q, k, v, out; 1: bfloat16. All four are
// contiguous and 16-byte aligned; D % 8 == 0, D <= 128, H % Hkv == 0,
// B * H <= 65535 (the wrapper checks each). Returns the cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int b, int sq, int skv, int h, int hkv, int d,
                    float scale, int causal, int window, int q_off,
                    int kv_off, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (d <= 0 || d > kMaxD || d % 8 != 0 || hkv <= 0 || h % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q, k, v, out, b, sq, skv, h, hkv, d, scale, causal,
                    window, q_off, kv_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, s)
                                     : dispatch<float>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
