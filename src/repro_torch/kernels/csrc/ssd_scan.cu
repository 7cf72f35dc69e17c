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
// Both kernels below keep the Pallas grid's sequential chunk axis as a loop
// inside one block per (head, batch row), with the [N, P] state that lived
// in VMEM kept on chip for the whole walk: no chunk state goes through
// device memory. B and C are read per group, never repeated to heads. A
// ragged last chunk is handled by bounds: rows past the sequence stage as
// zeros (dt = 0 is the identity decay and adds nothing), and nothing is
// padded in device memory. The decay exp(cum_i - cum_j) is masked to
// i >= j BEFORE the exp, as `_ssd_kernel` does: for i < j it overflows.
//
// 1. bfloat16 x, B, C: the tensor cores (`ssd_tc_kernel`).
//
//    What bounds it on the H100: bytes. At zamba2-2.7b's prefill (x
//    [8, 512, 80, 64], B/C [8, 512, 1, 64], chunk 128) the scan reads and
//    writes 139 MB once (y and the state in float32), 41.4 us at 3.35 TB/s;
//    the chunked form's 10.8 GFLOP take 10.9 us at the bf16 peak, about 19
//    with the split below. The FMA kernel of section 2 took 1.110 ms there:
//    its products ran on the float32 pipes, bound by shared-memory reads,
//    with one 181 KB block an SM and every load synchronous.
//
//    Design. Eight warps per (head, batch row). Each chunk's x, B and C
//    are staged as they lie in memory, bf16 with 16-byte `cp.async` copies
//    (8 bytes where N or P is not a multiple of 8), into a two-slot ring in
//    XOR-swizzled rows that `ldmatrix` reads without bank conflicts. The
//    next chunk's copies are issued once C S_in is done and land while the
//    chunk's other products run. dt is loaded into registers a chunk
//    ahead; every warp takes the prefix sum of dt * A log2(e) with
//    shuffles, and per-row terms (cum, dt, w and the factor gd below) go
//    to shared memory once a chunk; every decay is a power of 2
//    (`ex2.approx`, relative error about 2^-22).
//    Every product runs on `mma.sync` m16n8k16 (bf16 in, float32
//    accumulators), not `wgmma`: the tiles are small (a warp owns 16 rows
//    of the chunk and 16 of the state), and M is built in registers
//    between two products. Where one operand is float32, it is split into
//    bf16 terms, hi = bf16(v), lo = bf16(v - hi), and the product issued
//    once a term; the other operand (x, B or C) is exact in bf16:
//    - G = C B^T: both exact, one product, per 16-column block of j;
//    - y_intra = M x, M = G 2^(cum_i - cum_j) dt_j built from G's
//      accumulators in registers and reused as the A fragments (hi, lo):
//      M never reaches shared memory. Below the diagonal the power is a
//      row factor times a column factor gd_j, two `ex2` a block, not 8;
//    - y_inter = 2^cum_i (C S_in): the state in three terms (two miss the
//      bar once the state is large: 100x a unit state), read from the ring
//      slot the last chunk freed, the small terms summed first so that the
//      accumulator rounds at the large magnitude N / 16 times; the row
//      scale is applied afterwards so that C stays exact (scaling C first
//      would make both operands float);
//    - S_out = 2^total S_in + (w * B)^T x, w_j = 2^(total - cum_j) dt_j:
//      B^T's fragments come from `ldmatrix.trans`, are scaled by w in
//      registers and split. The state's float32 accumulators stay in
//      registers across chunks, 16 of its N rows a warp.
//    Every hi product is issued before the lo ones, so that the two never
//    wait on each other. Warps w and w + 4 share a scheduler and its tensor
//    cores: they take the chunk's 16-row tiles w and 7 - w, 9 blocks of the
//    causal triangle between them, and the state's tiles go one to each
//    such pair (N = 64) or one to each warp (N = 128).
//
//    Shared memory: two ring slots, each the larger of a chunk's x, B and
//    C tiles, Lc (2 N' + P') bf16, and the state's three terms, 3 N' P'
//    bf16, then 2 KB of per-row terms; N', P' are the widths padded to a
//    power of two >= 16 (padding columns are zeros). At N = P = 64,
//    Lc = 128: 2 x 49,152 + 2,048 = 100,352 bytes, so two blocks fit an
//    SM's 228 KB (1 KB reserved a block), 16 warps; ptxas holds them to
//    128 registers. 640 blocks (80 heads x 8 rows) are 2.4 waves at 132
//    SMs. N = 128 (mamba2-370m) runs the model's chunk of 128 in 165,888
//    bytes, one block an SM. The chunk is at most 128 (a 16-row tile a
//    warp); the wrapper halves it while the bytes exceed 227 KB. P' is at
//    most 64 and N' at most 128: wider tiles would not fit the registers.
//
//    Tolerance against the plain version: 1e-4 absolute + 1e-4 relative,
//    as in float32. A two-term split carries 16 bits of the float operand
//    (residual <= 2^-17 of it), three terms 24, the bf16 products are exact
//    in float32, and the sums are float32 in another order. One rounding
//    of each float operand to bf16 misses the bar, and so does a two-term
//    state at 100x; tests/test_torch_lm_kernels.py emulates all three.
//
// 2. float32 x, B, C: the FMA pipes (`ssd_kernel`), the parity dtype.
//
//    One block of 256 threads per (head, batch row). Per chunk the block
//    stages C and B transposed ([N, Lc]) and x ([Lc, P]) as float32, takes
//    the prefix sum of dt * A (one warp), builds M^T[j, i] =
//    (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j, then
//    y = M @ x + exp(cum) * (C @ S_in), and updates the state in place
//    (each thread owns the state elements it updates). Every product is a
//    loop over 4 x 4 register tiles with float4 reads of shared memory, on
//    the FMA pipes in float32 (nothing in TF32). Shared memory:
//    4 * (2 N Lc + Lc P + Lc^2 + N P + 3 Lc) bytes, 181,760 at the zamba2
//    shapes; the wrapper halves the chunk until it fits 227 KB. What bounds
//    it: operations, about Lc^2 N / 2 + Lc^2 P / 2 + 2 Lc N P
//    multiply-adds a chunk and (b, h) outside the tensor cores, one block
//    an SM. Tolerance: float32 sums in another order, 1e-4 absolute + 1e-4
//    relative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// 1. bfloat16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 256;      // eight warps
constexpr int kMaxLc = 128;        // a 16-row tile a warp
constexpr int kScanBytes = 4 * kMaxLc * 4;   // cum, dt, w, gd of a chunk

// One slot of the ring: a chunk's x, B and C tiles, or the state's split.
__host__ __device__ constexpr int slot_bytes(int nt, int pt, int lc) {
  return lc * (2 * nt + pt) > 3 * nt * pt ? lc * (2 * nt + pt) * 2
                                          : 3 * nt * pt * 2;
}
__host__ __device__ constexpr int smem_bytes(int nt, int pt, int lc) {
  return 2 * slot_bytes(nt, pt, lc) + kScanBytes;
}

// Byte offset of element (r, k) in a tile of rows of WT bf16: the 16-byte
// chunks of a row are XOR-swizzled so that the 8 rows an `ldmatrix` matrix
// reads at one chunk fall in 8 distinct bank groups.
template <int WT>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  constexpr int W = WT / 8;          // chunks a row: 2, 4, 8 or 16
  const int sw = W >= 8 ? (c ^ (r & 7)) : (c ^ ((r / (8 / W)) & (W - 1)));
  return static_cast<uint32_t>(r * WT * 2 + sw * 16);
}
template <int WT>
__device__ __forceinline__ uint32_t elem_off(int r, int k) {
  return chunk_off<WT>(r, k >> 3) + (k & 7) * 2;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
// (a, b) -> hi = bf16(a, b), lo = bf16((a, b) - hi), a in the low half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
// the same in three terms: hi + mid + lo
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  split(a - hf.x, b - hf.y, mid, lo);
  hi = as_u32(h);
}

// Rows [0, lc) of one operand of a chunk into a swizzled tile of WT
// columns: row i from global element src_row0 + i * stride, `width`
// elements; rows at or past `lr` stage as zeros.
template <int WT>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long src_row0,
                                           long long stride, int width,
                                           int lc, int lr) {
  if (width == WT) {          // whole rows: 16-byte pieces, no division
    constexpr int kPer = WT / 8;
    for (int idx = threadIdx.x; idx < lc * kPer; idx += kThreads) {
      const int i = idx / kPer, c = idx % kPer;
      const bool ok = i < lr;
      cp_async(dst + chunk_off<WT>(i, c),
               ok ? src + src_row0 + i * stride + 8 * c : src, 16, ok);
    }
    return;
  }
  const int bytes = width % 8 == 0 ? 16 : 8;
  const int per_row = width * 2 / bytes;
  for (int idx = threadIdx.x; idx < lc * per_row; idx += kThreads) {
    const int i = idx / per_row, piece = idx % per_row;
    const int k = piece * bytes / 2;             // first element
    const bool ok = i < lr;
    const __nv_bfloat16* g = ok ? src + src_row0 + i * stride + k : src;
    cp_async(dst + elem_off<WT>(i, k), g, bytes, ok);
  }
}

// Zero columns [width, WT) of `rows` rows: padding that no copy writes.
template <int WT>
__device__ __forceinline__ void zero_pad(uint8_t* tile, int rows, int width) {
  const int cols = WT - width;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, k = width + idx % cols;
    *reinterpret_cast<__nv_bfloat16*>(tile + elem_off<WT>(r, k)) =
        __float2bfloat16(0.0f);
  }
}

// NT, PT: N and P padded to a power of two >= 16 (NT <= 128, PT <= 64).
template <int NT, int PT>
__global__ void __launch_bounds__(kThreads, NT <= 64 ? 2 : 1)
    ssd_tc_kernel(SsdArgs a) {
  constexpr int KS = NT / 16;        // k steps over N
  constexpr int PN = PT / 8;         // n8 tiles over P
  constexpr int PP = PT / 16;        // ldmatrix.x4 loads over P
  constexpr int kSplit = NT * PT * 2;   // one term of the state's split
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) uint8_t smem[];
  const int lc = a.lc, n = a.n, p = a.p;
  const int tile_x = lc * PT * 2, tile_bc = lc * NT * 2;   // x, B, C
  const int slot = slot_bytes(NT, PT, lc);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // per row j of the chunk: cum_j (the prefix sum of dt A log2(e)), dt_j,
  // the state's weight w_j = 2^(total - cum_j) dt_j and, for the blocks of
  // M below the diagonal, gd_j = 2^(cum_{16 (j / 16 + 1)} - cum_j) dt_j
  float* const cum_s = reinterpret_cast<float*>(smem + 2 * slot);
  float* const dt_s = cum_s + kMaxLc;
  float* const w_s = dt_s + kMaxLc;
  float* const gd_s = w_s + kMaxLc;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;       // fragment row, column pair
  const int head = blockIdx.x, bi = blockIdx.y;
  const int gi = head / (a.h / a.g);
  const float A2 = a.A[head] * kLog2e;           // the decay in powers of 2
  const auto* const x = static_cast<const __nv_bfloat16*>(a.x);
  const auto* const B = static_cast<const __nv_bfloat16*>(a.B);
  const auto* const C = static_cast<const __nv_bfloat16*>(a.C);
  const long long head_state =
      (static_cast<long long>(bi) * a.h + head) * n * p;
  const long long row_bs = static_cast<long long>(bi) * a.s;   // (b, t=0)
  const int n_chunks = (a.s + lc - 1) / lc;
  // This warp's 16 rows of the chunk (y) and of N (the state). Warps w and
  // w + 4 share a scheduler and its tensor cores: they take row tiles w and
  // 7 - w, 9 blocks of the causal triangle between them, and one state tile
  // each (N = 128) or the first of the pair does (N <= 64).
  const int tile = warp < 4 ? warp : 11 - warp;
  const int r0 = 16 * tile;
  const bool owns_state = warp < KS;

  // A chunk's x, B and C tiles into ring slot st (the padding columns are
  // zeroed again: the state's split was there)
  auto stage_chunk = [&](int st, int c0) {
    const int lr = min(lc, a.s - c0);
    const uint32_t dst = base + st * slot;
    uint8_t* const at = smem + st * slot;
    if (p < PT) zero_pad<PT>(at, lc, p);
    if (n < NT) {
      zero_pad<NT>(at + tile_x, lc, n);
      zero_pad<NT>(at + tile_x + tile_bc, lc, n);
    }
    stage_rows<PT>(dst, x, ((row_bs + c0) * a.h + head) * p,
                   static_cast<long long>(a.h) * p, p, lc, lr);
    stage_rows<NT>(dst + tile_x, B, ((row_bs + c0) * a.g + gi) * n,
                   static_cast<long long>(a.g) * n, n, lc, lr);
    stage_rows<NT>(dst + tile_x + tile_bc, C, ((row_bs + c0) * a.g + gi) * n,
                   static_cast<long long>(a.g) * n, n, lc, lr);
  };
  // this lane's four rows of a chunk's dt (every warp holds all Lc rows)
  float dtr[4];
  auto load_dt = [&](int c0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      dtr[k] = i < lc && c0 + i < a.s ? a.dt[(row_bs + c0 + i) * a.h + head]
                                      : 0.0f;
    }
  };

  if (n_chunks > 0) stage_chunk(0, 0);
  cp_async_commit();
  load_dt(0);

  // The state: float32 accumulators, rows 16 warp + g (+ 8) of N, columns
  // 8 pt + 2 t (+ 1) of P. Its split into three bf16 terms feeds C S_in:
  // it is written into the ring slot the last chunk freed, and read before
  // the next chunk's loads go there.
  float sacc[PN][4];
#pragma unroll
  for (int pt = 0; pt < PN; ++pt)
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int r = 16 * warp + g + 8 * hv, c = 8 * pt + 2 * t;
      float2 v = make_float2(0.0f, 0.0f);
      if (a.s0 != nullptr && owns_state && r < n && c < p)
        v = *reinterpret_cast<const float2*>(a.s0 + head_state + r * p + c);
      sacc[pt][2 * hv] = v.x;
      sacc[pt][2 * hv + 1] = v.y;
    }
  auto write_state = [&](uint32_t dst) {
    if (!owns_state) return;
#pragma unroll
    for (int pt = 0; pt < PN; ++pt)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const uint32_t o = elem_off<PT>(16 * warp + g + 8 * hv, 8 * pt + 2 * t);
        uint32_t v[3];
        split3(sacc[pt][2 * hv], sacc[pt][2 * hv + 1], v[0], v[1], v[2]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
          asm volatile("st.shared.b32 [%0], %1;\n"
                       ::"r"(dst + term * kSplit + o), "r"(v[term])
                       : "memory");
      }
  };
  write_state(base + slot);

  // ldmatrix lane addressing: the row within a 16-row block and the chunk
  const int lr8 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * lc, lr = min(lc, a.s - c0);
    const uint32_t xs = base + (ci & 1) * slot;          // this chunk's x
    const uint32_t bs = xs + tile_x, cs = bs + tile_bc;
    const uint32_t ss = base + ((ci + 1) & 1) * slot;    // S_in's split

    // prefix sum of dt * A log2(e) over the chunk, in every warp
    float cum[4], run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += dtr[k] * A2;
      cum[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) cum[k] += excl;
    const float total = __shfl_sync(0xffffffffu, cum[3], 31);
    // cum at the first row of the next 16-row block (total after the last);
    // every lane takes part in the shuffle
    const float c_up = __shfl_sync(0xffffffffu, cum[0], ((lane | 3) + 1) & 31);
    const float c_next = lane >= 28 ? total : c_up;
    cp_async_wait_all();      // this thread's copies of chunk ci have landed
    if ((lane >> 2) == warp) {
      float w[4], gd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = ex2(total - cum[k]) * dtr[k];
        gd[k] = ex2(c_next - cum[k]) * dtr[k];
      }
      *reinterpret_cast<float4*>(cum_s + 4 * lane) =
          make_float4(cum[0], cum[1], cum[2], cum[3]);
      *reinterpret_cast<float4*>(dt_s + 4 * lane) =
          make_float4(dtr[0], dtr[1], dtr[2], dtr[3]);
      *reinterpret_cast<float4*>(w_s + 4 * lane) =
          make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(gd_s + 4 * lane) =
          make_float4(gd[0], gd[1], gd[2], gd[3]);
    }
    __syncthreads();          // chunk ci's tiles, S_in, cum and dt visible
    if (ci + 1 < n_chunks) load_dt(c0 + lc);

    const bool on = r0 < lr;  // this warp's rows hold part of the chunk
    float cum_i[2];
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) cum_i[hv] = cum_s[r0 + g + 8 * hv];

    // y = 2^cum_i * (C S_in), S_in = hi + mid + lo, the small terms summed
    // first: the accumulator rounds at the large magnitude only KS times
    float yacc[PN][4];
#pragma unroll
    for (int pt = 0; pt < PN; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.0f;
    if (on) {
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t af[4];
          ldsm(af, cs + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            uint32_t bf[4];
            ldsm_t(bf, ss + term * kSplit +
                           chunk_off<PT>(16 * ks + lr8 + 8 * q1, 2 * pp + q2));
            mma(yacc[2 * pp], af, bf[0], bf[1]);
            mma(yacc[2 * pp + 1], af, bf[2], bf[3]);
          }
        }
      const float e0 = ex2(cum_i[0]), e1 = ex2(cum_i[1]);
#pragma unroll
      for (int pt = 0; pt < PN; ++pt) {
        yacc[pt][0] *= e0;
        yacc[pt][1] *= e0;
        yacc[pt][2] *= e1;
        yacc[pt][3] *= e1;
      }
    }
    __syncthreads();          // every warp is done reading S_in's split
    if (ci + 1 < n_chunks) stage_chunk((ci + 1) & 1, c0 + lc);
    cp_async_commit();

    // S_out = 2^total S_in + (w * B)^T x and y += M x, by 16-row blocks of
    // the chunk's j
    const float decay = ex2(total);
#pragma unroll
    for (int pt = 0; pt < PN; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[pt][e] *= decay;
    // One 16-row block of the chunk's j. kM: 0 no part of M (the block is
    // past this warp's rows), 1 a block below the diagonal, 2 the
    // diagonal block; kS: the state's update. Every hi product is issued
    // before the lo ones, so the two never wait on each other.
    auto block = [&](auto m_kind, auto with_state, int kb) {
      constexpr int kM = decltype(m_kind)::value;
      constexpr bool kS = decltype(with_state)::value;
      const int j0 = 16 * kb;
      uint32_t mh[4], ml[4], wh[4], wl[4];
      if constexpr (kM != 0) {
        // G = C B^T, two chains over the k steps for each n8 tile
        float ga[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t af[4], bf[4];
          ldsm(af, cs + chunk_off<NT>(r0 + lr8 + 8 * q1, 2 * ks + q2));
          ldsm(bf, bs + chunk_off<NT>(j0 + lr8 + 8 * q2, 2 * ks + q1));
          mma(ga[ks & 1][0], af, bf[0], bf[1]);
          mma(ga[ks & 1][1], af, bf[2], bf[3]);
        }
        // M[i][j] = G[i][j] 2^(cum_i - cum_j) dt_j for i >= j; this
        // thread's columns are j0 + 2t (+1) and j0 + 8 + 2t (+1). Below the
        // diagonal the power is a row factor 2^(cum_i - cum_r) times gd_j,
        // r = j0 + 16 (both at most 1 while the decay does not grow); on
        // it, masked before the power.
        float m[2][4];
        if constexpr (kM == 1) {
          const float cr = cum_s[j0 + 16];
          const float rho[2] = {ex2(cum_i[0] - cr), ex2(cum_i[1] - cr)};
          const float2 gd0 =
              *reinterpret_cast<const float2*>(gd_s + j0 + 2 * t);
          const float2 gd1 =
              *reinterpret_cast<const float2*>(gd_s + j0 + 8 + 2 * t);
          const float gd[2][2] = {{gd0.x, gd0.y}, {gd1.x, gd1.y}};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[u][e] = (ga[0][u][e] + ga[1][u][e]) * rho[e >> 1] *
                        gd[u][e & 1];
        } else {
          const float2 c0 =
              *reinterpret_cast<const float2*>(cum_s + j0 + 2 * t);
          const float2 c1 =
              *reinterpret_cast<const float2*>(cum_s + j0 + 8 + 2 * t);
          const float2 d0 = *reinterpret_cast<const float2*>(dt_s + j0 + 2 * t);
          const float2 d1 =
              *reinterpret_cast<const float2*>(dt_s + j0 + 8 + 2 * t);
          const float cj[2][2] = {{c0.x, c0.y}, {c1.x, c1.y}};
          const float dj[2][2] = {{d0.x, d0.y}, {d1.x, d1.y}};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = g + 8 * (e >> 1), j = 8 * u + 2 * t + (e & 1);
              const bool keep = i >= j;             // rows of this block
              const float d = keep ? cum_i[e >> 1] - cj[u][e & 1] : 0.0f;
              m[u][e] = keep ? (ga[0][u][e] + ga[1][u][e]) * ex2(d) *
                                   dj[u][e & 1]
                             : 0.0f;
            }
        }
        split(m[0][0], m[0][1], mh[0], ml[0]);   // rows g, j 2t
        split(m[0][2], m[0][3], mh[1], ml[1]);   // rows g + 8
        split(m[1][0], m[1][1], mh[2], ml[2]);   // rows g, j 8 + 2t
        split(m[1][2], m[1][3], mh[3], ml[3]);
      }
      if constexpr (kS) {
        // A fragments of B^T (rows n, columns j) scaled by w_j
        const float2 w0 = *reinterpret_cast<const float2*>(w_s + j0 + 2 * t);
        const float2 w1 =
            *reinterpret_cast<const float2*>(w_s + j0 + 8 + 2 * t);
        uint32_t bt[4];
        ldsm_t(bt, bs + chunk_off<NT>(j0 + lr8 + 8 * q2, 2 * warp + q1));
        const float2 f0 = unpack(bt[0]), f1 = unpack(bt[1]);
        const float2 f2 = unpack(bt[2]), f3 = unpack(bt[3]);
        split(f0.x * w0.x, f0.y * w0.y, wh[0], wl[0]);
        split(f1.x * w0.x, f1.y * w0.y, wh[1], wl[1]);
        split(f2.x * w1.x, f2.y * w1.y, wh[2], wl[2]);
        split(f3.x * w1.x, f3.y * w1.y, wh[3], wl[3]);
      }
      uint32_t xf[PP][4];     // x rows j0.., B fragments of n8 tiles 2pp, +1
#pragma unroll
      for (int pp = 0; pp < PP; ++pp)
        ldsm_t(xf[pp], xs + chunk_off<PT>(j0 + lr8 + 8 * q1, 2 * pp + q2));
      auto products = [&](const uint32_t (&am)[4], const uint32_t (&aw)[4]) {
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) {
          if constexpr (kM != 0) {
            mma(yacc[2 * pp], am, xf[pp][0], xf[pp][1]);
            mma(yacc[2 * pp + 1], am, xf[pp][2], xf[pp][3]);
          }
          if constexpr (kS) {
            mma(sacc[2 * pp], aw, xf[pp][0], xf[pp][1]);
            mma(sacc[2 * pp + 1], aw, xf[pp][2], xf[pp][3]);
          }
        }
      };
      products(mh, wh);
      products(ml, wl);
    };
    using Off = std::integral_constant<int, 1>;
    using Diag = std::integral_constant<int, 2>;
    using NoM = std::integral_constant<int, 0>;
    const int n_kb = (lr + 15) / 16;
    const int n_m = on ? tile : -1;          // blocks below the diagonal
    if (owns_state) {
      for (int kb = 0; kb < n_m; ++kb) block(Off{}, std::true_type{}, kb);
      if (on) block(Diag{}, std::true_type{}, tile);
      for (int kb = n_m + 1; kb < n_kb; ++kb)
        block(NoM{}, std::true_type{}, kb);
    } else if (on) {
      for (int kb = 0; kb < n_m; ++kb) block(Off{}, std::false_type{}, kb);
      block(Diag{}, std::false_type{}, tile);
    }

    // this warp's rows of y, float2 a thread
    if (on)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int i = r0 + g + 8 * hv;
        if (i >= lr) continue;
        float* const yo = a.y + ((row_bs + c0 + i) * a.h + head) * p;
#pragma unroll
        for (int pt = 0; pt < PN; ++pt) {
          const int c = 8 * pt + 2 * t;
          if (c < p)
            *reinterpret_cast<float2*>(yo + c) =
                make_float2(yacc[pt][2 * hv], yacc[pt][2 * hv + 1]);
        }
      }
    __syncthreads();          // every warp is done with chunk ci's slot
    write_state(xs);          // S_out's split for chunk ci + 1
  }

  if (owns_state)
#pragma unroll
    for (int pt = 0; pt < PN; ++pt)
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int r = 16 * warp + g + 8 * hv, c = 8 * pt + 2 * t;
        if (r < n && c < p)
          *reinterpret_cast<float2*>(a.state + head_state + r * p + c) =
              make_float2(sacc[pt][2 * hv], sacc[pt][2 * hv + 1]);
      }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// 2. float32: the FMA pipes
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
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

using Kernel = void (*)(SsdArgs);

// the padded width a tensor-core kernel takes: a power of two >= 16
int pad_width(int v) {
  int w = 16;
  while (w < v) w *= 2;
  return w;
}

template <int NT>
Kernel tc_kernel_p(int pt) {
  switch (pt) {
    case 16: return tc::ssd_tc_kernel<NT, 16>;
    case 32: return tc::ssd_tc_kernel<NT, 32>;
    case 64: return tc::ssd_tc_kernel<NT, 64>;
  }
  return nullptr;
}

// The kernel, its threads and its dynamic shared memory for these shapes;
// null when they are outside the kernel's range.
Kernel pick(int dtype, int n, int p, int lc, int* threads, int* smem) {
  if (dtype == 0) {
    *threads = kThreads;
    *smem = smem_bytes(n, p, lc);
    return lc >= 4 && lc % 4 == 0 ? ssd_kernel<float> : nullptr;
  }
  const int nt = pad_width(n), pt = pad_width(p);
  *threads = tc::kThreads;
  *smem = tc::smem_bytes(nt, pt, lc);
  if (lc < 16 || lc > tc::kMaxLc || lc % 16 != 0) return nullptr;
  switch (nt) {
    case 16: return tc_kernel_p<16>(pt);
    case 32: return tc_kernel_p<32>(pt);
    case 64: return tc_kernel_p<64>(pt);
    case 128: return tc_kernel_p<128>(pt);
  }
  return nullptr;
}

// The opt-in above 48 KB and the largest shared-memory carveout, once per
// kernel.
cudaError_t configure(Kernel k) {
  constexpr int kKinds = 13;
  static Kernel done[kKinds] = {};
  for (int i = 0; i < kKinds; ++i)
    if (done[i] == k) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < kKinds; ++i)
    if (done[i] == nullptr) {
      done[i] = k;
      break;
    }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The dynamic shared memory a block takes: dtype 0 (float32, the FMA
// kernel) or 1 (bfloat16, the tensor-core kernel), N, P and the chunk.
int ssd_scan_smem(int dtype, int n, int p, int lc) {
  int threads = 0, smem = 0;
  pick(dtype, n, p, lc, &threads, &smem);
  return smem;
}

// The blocks an SM holds for these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns the cudaError_t.
int ssd_scan_occupancy(int dtype, int n, int p, int lc, int* blocks) {
  int threads = 0, smem = 0;
  const Kernel k = pick(dtype, n, p, lc, &threads, &smem);
  if (k == nullptr || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, reinterpret_cast<const void*>(k), threads, smem);
  return static_cast<int>(err);
}

// One launch. dtype 0: float32 x, B, C (the FMA kernel); 1: bfloat16 (the
// tensor-core kernel, N <= 128, P <= 64). dt, A, s0 (null: a zero initial
// state), y and state are float32. Everything contiguous and 16-byte
// aligned; P % 4 == 0, N % 4 == 0, H % G == 0, Bt <= 65535; lc the chunk of
// `ssd_plan` (repro_torch/kernels/ssd_scan.py): a multiple of 4 for
// float32, of 16 up to 128 for bfloat16, within 227 KB of shared memory
// (the wrapper checks each). Returns the cudaError_t.
int ssd_scan(const void* x, const float* dt, const float* A, const void* B,
             const void* C, const float* s0, float* y, float* state,
             int dtype, int bt, int s, int h, int p, int g, int n, int lc,
             void* stream) {
  if (bt <= 0 || h <= 0) return 0;
  int threads = 0, smem = 0;
  const Kernel k = pick(dtype, n, p, lc, &threads, &smem);
  if (k == nullptr || p % 4 != 0 || n % 4 != 0 || g <= 0 || h % g != 0 ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = configure(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SsdArgs a{x, dt, A, B, C, s0, y, state, bt, s, h, p, g, n, lc};
  k<<<dim3(h, bt), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
