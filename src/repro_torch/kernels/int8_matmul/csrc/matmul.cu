// ITA's quantized linear layer for Hopper: the int8 x int8 -> int32 GEMM
// with the bias add and per-channel requantization fused at the end.
// Replaces the two Pallas schedules behind `int8_matmul_pallas`
// (src/repro/kernels/int8_matmul/kernel.py):
//
// - `int8_matmul_launch` (B7a, `matmul_kernel`, kernel.py:38-52 and 89):
//   a block owns a 128 x 128 output tile, walks K in order, accumulating
//   in int32 registers, and applies the epilogue once at the end.
// - `int8_matmul_ws_launch` (B7b, `matmul_ws_kernel`, kernel.py:55-70 and
//   113): the paper's weight-stationary schedule, one launch per k tile
//   of `bk`. A block loads its (bk x 128) weight tile into shared memory
//   once, then streams every 128-row tile of x past it, reading, adding
//   to and writing back the int32 partial sums in device memory (the
//   paper's 2·N·D partial-sum term); the last k tile adds the bias and
//   requantizes. Only ceil(N / 128) blocks run per launch: the schedule's
//   own cost on a card with 132 SMs.
//
// Both compute the same function; the accumulator is an exact int32 sum,
// so the result does not depend on the tiles, and both equal the plain
// version bit for bit. Epilogue: __int2float_rn(acc + bias) (half to even
// above 2^24), __fmul_rn by the float32 multiplier, rintf (half to even),
// clamp to [-128, 127].
//
// Products: `mma.sync.m16n8k32` s8 x s8 -> s32 tensor-core tiles. Each of
// 8 warps owns a 64 x 32 part of the block tile (4 x 4 mma tiles). The B
// operand wants 4 consecutive k of one column in a 32-bit register, but
// w is (K, N) row-major, so each thread loads a 4 x 4 byte block (4 rows
// of 4 columns) and transposes it with __byte_perm on its way into shared
// memory, where the weight tile is stored n-major (k contiguous). Shared
// rows are padded by 16 bytes so that the fragment loads hit 32 distinct
// banks.
//
// What bounds it: at the model's prefill shapes (M = 2048) the operations
// (2·M·N·K at 1979 TOP/s); at decode shapes (M = 4) the weight read. This
// first design uses the older warp-level mma.sync, 4-byte loads and a
// one-stage register prefetch, not wgmma/TMA, so it stays well below the
// tensor-core peak. B7b adds its partial-sum traffic, 2·4·M·N bytes per
// k tile.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;              // rows of a block tile
constexpr int kBN = 128;              // columns of a block tile
constexpr int kBK = 64;               // k bytes of a shared-memory chunk
constexpr int kThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kPad = 16;              // row padding of shared tiles (bytes)
constexpr int kAStride = kBK + kPad;  // A chunk row (bytes)
constexpr int kMaxSmem = 232448;      // a block's shared memory on sm_90

// A chunk: kBM x kBK bytes = 2048 words, 8 per thread.
constexpr int kAWords = kBM * kBK / 4 / kThreads;

struct Acc {
  int c[4][4][4];                     // [m16 tile][n8 tile][fragment]
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Load the A chunk x[m0 : m0+kBM, k : k+kBK] (zero outside rows < m and
// columns < kend) into registers. Word i of a thread is row idx / 16,
// word idx % 16 of the chunk row, idx = threadIdx.x + i·kThreads.
__device__ __forceinline__ void load_a(unsigned (&r)[kAWords],
                                       const int8_t* __restrict__ x, int m,
                                       int kdim, int m0, int k, int kend) {
#pragma unroll
  for (int i = 0; i < kAWords; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int row = m0 + idx / (kBK / 4);
    const int col = k + 4 * (idx % (kBK / 4));
    r[i] = (row < m && col < kend)
               ? __ldg(reinterpret_cast<const unsigned*>(
                     x + static_cast<long long>(row) * kdim + col))
               : 0u;
  }
}

__device__ __forceinline__ void store_a(int8_t* as,
                                        const unsigned (&r)[kAWords]) {
#pragma unroll
  for (int i = 0; i < kAWords; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    *reinterpret_cast<unsigned*>(as + (idx / (kBK / 4)) * kAStride +
                                 4 * (idx % (kBK / 4))) = r[i];
  }
}

// The 4 x 4 byte block of w at rows kg·4 + [0,4) of `rows`, columns
// ng·4 + [0,4) of a 128-column tile, for the calling thread's lane and
// warp in an 8-k-group step `it`: lanes cover 8 column groups x 4 k
// groups, so each load of a warp reads 4 rows x 32 contiguous bytes.
struct BlockB {
  int kg, ng;
};

__device__ __forceinline__ BlockB block_b(int it) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  return {it * 8 + (warp / 4) * 4 + lane / 8, (warp % 4) * 8 + lane % 8};
}

// Load rows [kg·4, kg·4+4) of the weight tile (global rows k + ..., zero
// at rows >= kend or columns >= n) and return them transposed: o[i] holds
// w[k+kg·4 .. +3][n0 + ng·4 + i], the 4 k of one column, as the mma B
// fragment wants them.
__device__ __forceinline__ void load_b_block(
    unsigned (&o)[4], const int8_t* __restrict__ w, int n, int k, int kend,
    int n0, BlockB b) {
  unsigned r[4];
  const int col = n0 + 4 * b.ng;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = k + 4 * b.kg + j;
    r[j] = (row < kend && col < n)
               ? __ldg(reinterpret_cast<const unsigned*>(
                     w + static_cast<long long>(row) * n + col))
               : 0u;
  }
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void store_b_block(int8_t* bs, int b_stride,
                                              const unsigned (&o)[4],
                                              BlockB b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<unsigned*>(bs + (4 * b.ng + i) * b_stride +
                                 4 * b.kg) = o[i];
}

// acc += As[:, 0:kBK] · Bs[:, kb:kb+kBK]ᵀ over the warp's 64 x 32 part.
__device__ __forceinline__ void mma_chunk(Acc& acc, const int8_t* as,
                                          const int8_t* bs, int b_stride,
                                          int kb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int8_t* a0 = as + ((warp / 4) * 64 + g) * kAStride + 4 * t;
  const int8_t* b0 = bs + ((warp % 4) * 32 + g) * b_stride + kb + 4 * t;
#pragma unroll
  for (int s = 0; s < kBK; s += 32) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = a0 + mi * 16 * kAStride + s;
      a[mi][0] = lds(p);
      a[mi][1] = lds(p + 8 * kAStride);
      a[mi][2] = lds(p + 16);
      a[mi][3] = lds(p + 8 * kAStride + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = b0 + ni * 8 * b_stride + s;
      b[ni][0] = lds(p);
      b[ni][1] = lds(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc.c[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc.c[mi][ni][f] = 0;
}

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32, as XLA
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int8_t requant(int acc, float mult) {
  const float y = rintf(__fmul_rn(__int2float_rn(acc), mult));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(y, -128.f), 127.f)));
}

// Visit the thread's accumulator pairs: fn(row, col, v0, v1) for output
// elements (row, col) and (row, col + 1), rows < m and columns < n only
// (n is a multiple of 4, so col + 1 < n too).
template <typename Fn>
__device__ __forceinline__ void for_each_pair(const Acc& acc, int m, int n,
                                              int m0, int n0, Fn fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (warp / 4) * 64 + mi * 16 + g + 8 * h;
        const int col = n0 + (warp % 4) * 32 + ni * 8 + 2 * t;
        if (row < m && col < n)
          fn(row, col, acc.c[mi][ni][2 * h], acc.c[mi][ni][2 * h + 1]);
      }
}

// B7a: grid (ceil(n / kBN), ceil(m / kBM)); one output tile per block.
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int* __restrict__ bias, const float* __restrict__ mult,
              int8_t* __restrict__ out, int m, int n, int kdim) {
  __shared__ __align__(16) int8_t as[kBM * kAStride];
  __shared__ __align__(16) int8_t bs[kBN * kAStride];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  Acc acc;
  zero(acc);
  unsigned ra[kAWords], rb[2][4];
  auto load = [&](int k) {
    load_a(ra, x, m, kdim, m0, k, kdim);
#pragma unroll
    for (int it = 0; it < 2; ++it)
      load_b_block(rb[it], w, n, k, kdim, n0, block_b(it));
  };
  if (kdim > 0) load(0);
  for (int k = 0; k < kdim; k += kBK) {
    __syncthreads();                       // the last chunk's mma is done
    store_a(as, ra);
#pragma unroll
    for (int it = 0; it < 2; ++it) store_b_block(bs, kAStride, rb[it],
                                                 block_b(it));
    __syncthreads();
    if (k + kBK < kdim) load(k + kBK);     // in flight during the mma
    mma_chunk(acc, as, bs, kAStride, 0);
  }
  for_each_pair(acc, m, n, m0, n0, [&](int row, int col, int v0, int v1) {
    char2 q;
    q.x = requant(wrap_add(v0, bias[col]), mult[col]);
    q.y = requant(wrap_add(v1, bias[col + 1]), mult[col + 1]);
    *reinterpret_cast<char2*>(out + static_cast<long long>(row) * n + col) = q;
  });
}

// B7b, one k tile [k0, k0 + bk): grid ceil(n / kBN). The weight tile is
// stored n-major with rows of bkp + kPad bytes (bkp: bk rounded up to
// kBK, zero-filled), followed by one A chunk.
__global__ void __launch_bounds__(kThreads)
matmul_ws_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int* __restrict__ bias, const float* __restrict__ mult,
                 int* __restrict__ psum, int8_t* __restrict__ out, int m,
                 int n, int kdim, int k0, int bk, int final) {
  extern __shared__ __align__(16) int8_t smem[];
  const int bkp = (bk + kBK - 1) / kBK * kBK;
  const int b_stride = bkp + kPad;
  int8_t* bs = smem;
  int8_t* as = smem + kBN * b_stride;
  const int n0 = blockIdx.x * kBN, kend = k0 + bk;

  // the weight tile, once
  for (int it = 0; it < bkp / 32; ++it) {
    unsigned o[4];
    const BlockB b = block_b(it);
    load_b_block(o, w, n, k0, kend, n0, b);
    store_b_block(bs, b_stride, o, b);
  }

  // stream every row tile past it, a kBK chunk of x at a time
  const int chunks = bkp / kBK, steps = (m + kBM - 1) / kBM * chunks;
  unsigned ra[kAWords];
  Acc acc;
  if (steps > 0) load_a(ra, x, m, kdim, 0, k0, kend);
  for (int s = 0; s < steps; ++s) {
    const int m0 = s / chunks * kBM, kc = s % chunks * kBK;
    if (kc == 0) zero(acc);
    __syncthreads();                       // the last chunk's mma is done
    store_a(as, ra);
    __syncthreads();
    if (s + 1 < steps) {
      const int next = s + 1;
      load_a(ra, x, m, kdim, next / chunks * kBM, k0 + next % chunks * kBK,
             kend);
    }
    mma_chunk(acc, as, bs, b_stride, kc);
    if (kc + kBK < bkp) continue;
    // read-add-write of the partial sums; the last k tile requantizes
    for_each_pair(acc, m, n, m0, n0, [&](int row, int col, int v0, int v1) {
      const long long at = static_cast<long long>(row) * n + col;
      int2 p = *reinterpret_cast<const int2*>(psum + at);
      p.x = wrap_add(p.x, v0);
      p.y = wrap_add(p.y, v1);
      *reinterpret_cast<int2*>(psum + at) = p;
      if (final) {
        char2 q;
        q.x = requant(wrap_add(p.x, bias[col]), mult[col]);
        q.y = requant(wrap_add(p.y, bias[col + 1]), mult[col + 1]);
        *reinterpret_cast<char2*>(out + at) = q;
      }
    });
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x (m, kdim) int8, w (kdim, n) int8, bias (n,) int32, mult (n,) f32 ->
// out (m, n) int8; kdim and n multiples of 4, x and w 4-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* bias, const void* mult,
                                  void* out, int m, int n, int kdim,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kdim < 0 || kdim % 4 || n % 4 || !aligned(x, 4) || !aligned(w, 4) ||
      !aligned(out, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<const float*>(mult),
      static_cast<int8_t*>(out), m, n, kdim);
  return static_cast<int>(cudaGetLastError());
}

// One weight-stationary k tile: psum (m, n) int32 += x[:, k0:k0+bk] ·
// w[k0:k0+bk, :]; with `final`, out (m, n) int8 = requant(psum + bias).
// bk, kdim and n multiples of 4; psum 8-byte aligned.
extern "C" int int8_matmul_ws_launch(const void* x, const void* w,
                                     const void* bias, const void* mult,
                                     void* psum, void* out, int m, int n,
                                     int kdim, int k0, int bk, int final,
                                     void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int bkp = (bk + kBK - 1) / kBK * kBK;
  const int smem = kBN * (bkp + kPad) + kBM * kAStride;
  if (bk <= 0 || bk % 4 || kdim % 4 || n % 4 || k0 < 0 || k0 + bk > kdim ||
      smem > kMaxSmem || !aligned(x, 4) || !aligned(w, 4) ||
      !aligned(psum, 8) || !aligned(out, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  matmul_ws_kernel<<<(n + kBN - 1) / kBN, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<const float*>(mult),
      static_cast<int*>(psum), static_cast<int8_t*>(out), m, n, kdim, k0, bk,
      final);
  return static_cast<int>(cudaGetLastError());
}
