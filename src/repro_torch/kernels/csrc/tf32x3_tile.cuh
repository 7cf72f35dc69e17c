// A float32 product on Hopper's tensor cores in a 3xTF32 split: a 128x128
// output tile per block of two warpgroups (256 threads), depth 32 per
// shared-memory stage, a ring of three stages filled by 16-byte
// asynchronous copies (cp.async), so that two stages are in flight while
// one is multiplied. fused_mp.cu's node phase runs on it; dense_aggregate.cu's
// dense strips can move onto it (ROADMAP B7).
//
// Why a split. One TF32 product rounds each operand to 11 significant bits,
// about 1e-3 relative, so it does not hold float32's bar (1e-4 absolute +
// 1e-4 relative against the plain version at depth 1024;
// tests/test_torch_kernels.py emulates both). Each float32 operand v is
// split into hi = tf32_rna(v) and lo = v - hi (exact in float32); the
// product sums A_lo*B_hi + A_hi*B_lo + A_hi*B_hi and drops A_lo*B_lo, about
// 2^-22 of the result. hi's rounding is explicit (cvt.rna.tf32.f32): a raw
// float32 fed to a tf32 product is cut to its top 19 bits by the hardware,
// which for lo costs about 2^-22 of v more. The two small products go into
// their own accumulator, so the large one is not rounded at its magnitude
// three times per depth step.
//
// wgmma: A from registers, B split and transposed in advance. wgmma is the
// one way to the tensor cores' full rate. In tf32 it reads B from shared
// memory K-major only, and a kernel's B (fused_mp.cu: the weights, [F, H]
// row-major) is N-major; it is also the same for every block. So
// split_transpose_kernel writes it once a call as two K-major arrays, hi
// and lo ([N][K], K padded to whole stages), which the ring's copies place
// straight into 128-byte-swizzled tiles. A is built from raw tiles
// (fused_mp.cu: x, agg * 1/d, s * x), so it goes through registers anyway:
// warp w of the block loads its rows 16 w .. +15 with ldmatrix in the layout
// of wgmma's register A operand, the kernel builds the values, and the warp
// splits them there. Each A element is read and split once, and only B is
// read from shared memory by the products (an A split in shared memory too
// measured slower: the products' operand reads and the ring's copies then
// took more of the shared memory's bandwidth than the tensor cores' rate
// leaves).
//
// Overlap. Each depth step of 8 issues three m64n128k8 products per
// warpgroup (its 64 rows of the tile). A stage goes in two halves of two
// steps: a half's products run while the warpgroup builds the next half's
// fragments, into registers of their own, and a half's registers are
// rebuilt only once the products that read them have finished (wgmma's
// wait on all but the newest group). A stage's copies are issued two stages
// ahead, into the slot whose products the whole block has finished.
//
// Shared memory: a stage holds the raw A tiles [128][32] (one for a kernel
// that builds A from one source, two for two) and B's hi and lo tiles, all
// with 128-byte rows under the 128-byte swizzle, so that each 8-row phase
// of ldmatrix or of the copies hits 32 distinct banks: 49,152 or 65,536
// bytes a stage, three stages. One block an SM (about 200 registers a
// thread: two accumulators of 64, and the fragments of two halves).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {
namespace tf32x3 {

constexpr int kBM = 128;      // output rows per block: two warpgroups of 64
constexpr int kBN = 128;      // output columns per block: one m64n128 each
constexpr int kBK = 32;       // depth per shared-memory stage: a 128 B row
constexpr int kStages = 3;    // the ring: two stages in flight, one in use
constexpr int kThreads = 256;

// kRawA raw A tiles (a float at swizzled(row, depth) / 4), then B's hi and
// lo (a word at swizzled(column, depth) / 4)
template <int kRawA>
struct Stage {
  float a[kRawA][kBM * kBK];
  uint32_t b[2][kBN * kBK];
};
// the ring, and room to align it to 1024 bytes for the swizzle
template <int kRawA>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + kStages * static_cast<int>(sizeof(Stage<kRawA>));
}
static_assert(sizeof(Stage<1>) % 1024 == 0 && sizeof(Stage<2>) % 1024 == 0,
              "swizzled tiles must stay 1024-aligned");
static_assert(smem_bytes<2>() <= 232448, "more than a block's shared memory");

// one m64n128 accumulator: n8 tile j holds (row g, columns 8j + 2t, +1) in
// [4j], [4j + 1] and row g + 8 in [4j + 2], [4j + 3], g = lane / 4,
// t = lane % 4, rows counted from the warp's 16
using Acc = float[kBN / 2];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !ok (then
// nothing is read; src must still be a valid address)
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of (column n, depth k) in a K-major tile of 128-byte rows
// with the 128-byte swizzle: the 16-byte chunk k / 4 of row n lies at
// chunk (k / 4) ^ (n % 8)
__device__ __forceinline__ uint32_t swizzled(int n, int k) {
  return n * 128 + ((((k >> 2) ^ n) & 7) << 4) + ((k & 3) << 2);
}

// The tile row of this thread's A fragment and accumulator elements: h = 0
// row g, h = 1 row g + 8 of its warp's 16 (warp w of the block owns rows
// 16 w .. 16 w + 15, the layout of wgmma's register A operand)
__device__ __forceinline__ int frag_row(int h) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// The warp's A fragment at depths k8 .. k8+7 of a raw A tile (a float at
// swizzled(row, depth) / 4): v[0] = (row g, depth t), v[1] = (g + 8, t),
// v[2] = (g, t + 4), v[3] = (g + 8, t + 4), t = lane % 4. ldmatrix moves
// 32-bit words as pairs of b16, so its four 8 x (4 floats) matrices are
// exactly these four registers; each of its 16-byte rows is one swizzled
// chunk.
__device__ __forceinline__ void load_frag(float (&v)[4], const float* a,
                                          int k8) {
  const int lane = threadIdx.x & 31;
  const int row =
      16 * (threadIdx.x >> 5) + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int k = k8 + 4 * (lane >> 4);
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(a) + swizzled(row, k))
      : "memory");
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = __uint_as_float(r[u]);
}

// hi = v rounded to nearest TF32, ties away from zero; lo = v - hi, exact
// in float32, of which the tensor cores read the top 19 bits (a second
// rounding of lo measured no more accurate on the card, and slower)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A wgmma shared-memory descriptor for a 128B-swizzled K-major operand:
// start address, leading byte offset (unused: a depth step of 8 tf32 lies
// in one swizzled row), stride byte offset 1024 (8 rows), swizzle mode 1
// (128B) in bits 62-63. A depth step inside the row advances the start by
// 32 bytes; the hardware applies the swizzle to the address it computes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += a b: wgmma m64n128k8, A (tf32) from registers, B (tf32) K-major from
// shared memory, float32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The block's ring, 1024-byte aligned for the swizzle
template <int kRawA>
__device__ __forceinline__ Stage<kRawA>* carve(unsigned char* raw) {
  return reinterpret_cast<Stage<kRawA>*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// B as split_transpose_kernel leaves it: hi and lo, [N][ldk] with K
// contiguous, zero past the real depths; the block's columns n0 .. n0+127,
// of which those below n_end are real.
struct SplitB {
  const uint32_t* hi;
  const uint32_t* lo;
  long long ldk;
  int n0, n_end;
};

// Stage kt of B: 8 of the 2 x 128 rows x 8 chunks a thread, each 16-byte
// chunk to its swizzled place; zeros past n_end.
template <int kRawA>
__device__ __forceinline__ void issue_b(const SplitB& b, int kt,
                                        Stage<kRawA>& st) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kBN * (kBK / 4) / kThreads; ++u) {
    const int c = tid + u * kThreads;
    const int n = c / (kBK / 4), k = 4 * (c % (kBK / 4));
    const bool ok = b.n0 + n < b.n_end;
    const long long off =
        ok ? static_cast<long long>(b.n0 + n) * b.ldk + kt * kBK + k : 0;
    const int dst = swizzled(n, k) / 4;
    cp_async16(&st.b[0][dst], b.hi + off, ok);
    cp_async16(&st.b[1][dst], b.lo + off, ok);
  }
}

// big + small = the product over `ktiles` stages of depth kBK.
// issue_a(kt, stage) starts the asynchronous copies of stage kt's raw A
// tiles into a ring slot (it commits nothing); frag(kt, stage, k8, v)
// writes the warp's A fragment at depths k8 .. k8+7 of stage kt into v
// (load_frag of the stage's raw tiles, and the kernel's arithmetic). Ends
// with no copy or product in flight and all shared memory free.
template <int kRawA, class IssueA, class Frag>
__device__ __forceinline__ void mainloop(Stage<kRawA>* ring, const SplitB& b,
                                         int ktiles, Acc& big, Acc& small,
                                         IssueA issue_a, Frag frag) {
  // A's fragments, hi and lo, of the two depth steps of each half stage;
  // a half's registers are rebuilt only once its products have finished
  uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) big[i] = small[i] = 0.0f;
  fence_regs<kBN / 2>(big);
  fence_regs<kBN / 2>(small);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      issue_a(s, ring[s]);
      issue_b(b, s, ring[s]);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    wgmma_wait<1>();               // this warpgroup's first half of kt-1 done
    __syncthreads();               // everyone's copies of stage kt landed
    const Stage<kRawA>& st = ring[kt % kStages];
    const uint32_t b_hi = smem_u32(st.b[0]), b_lo = smem_u32(st.b[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1) {
        wgmma_wait<1>();   // this warpgroup's second half of kt-1 done
        __syncthreads();   // everyone's: slot kt-1 is free
        const int next = kt + kStages - 1;
        if (next < ktiles) {
          issue_a(next, ring[next % kStages]);
          issue_b(b, next, ring[next % kStages]);
        }
        cp_async_commit();
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v[4];
        frag(kt, st, 16 * h + 8 * j, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) split(v[u], ah[h][j][u], al[h][j][u]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = 2 * h + j;
        const uint64_t bh = desc(b_hi + 32 * s);
        const uint64_t bl = desc(b_lo + 32 * s);
        mma(small, al[h][j], bh);
        mma(small, ah[h][j], bl);
        mma(big, ah[h][j], bh);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs<kBN / 2>(big);
  fence_regs<kBN / 2>(small);
  cp_async_wait<0>();
  __syncthreads();
}

// B for the mainloop: out_hi / out_lo [N][nseg * kp] = the split of
// w_seg[k][n] ([K, N] row-major, seg 0 from w0, seg 1 from w1) at column
// seg * kp + k, zero for f <= k < kp. Grid (ceil(N / 32), kp / 32, nseg),
// block (32, 8): a 32 x 32 transpose through shared memory, both sides
// coalesced.
__global__ void __launch_bounds__(256) split_transpose_kernel(
    const float* w0, const float* w1, int f, int n, int kp, uint32_t* out_hi,
    uint32_t* out_lo) {
  __shared__ float t[32][33];
  const int seg = blockIdx.z;
  const float* w = seg == 0 ? w0 : w1;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, c = n0 + tx;
    t[r][tx] = (k < f && c < n) ? w[static_cast<long long>(k) * n + c] : 0.0f;
  }
  __syncthreads();
  const long long ld = static_cast<long long>(gridDim.z) * kp;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int c = n0 + r;
    if (c >= n) continue;
    uint32_t hi, lo;
    split(t[tx][r], hi, lo);
    const long long o = c * ld + seg * kp + k0 + tx;
    out_hi[o] = hi;
    out_lo[o] = lo;
  }
}

}  // namespace tf32x3
}  // namespace
