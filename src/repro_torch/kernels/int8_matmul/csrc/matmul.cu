// ITA's quantized linear layer for Hopper: the int8 x int8 -> int32 GEMM
// with the bias add and per-channel requantization fused at the end.
// Replaces the two Pallas schedules behind `int8_matmul_pallas`
// (src/repro/kernels/int8_matmul/kernel.py). Every kernel here takes the
// weight K-major: wt (n, ld) holds w[k, c] at wt[c·ld + k], the (N, K)
// buffer behind a (K, N) view `w.t().contiguous().t()` (the wrapper
// transposes a row-major w once per call). wgmma reads 8-bit operands
// only K-major, and a K-major row is what an mma.sync B fragment holds.
//
// B7a (`matmul_kernel`, kernel.py:38-52 and 89), `int8_matmul_launch`, in
// one of two geometries that `kernel.matmul_geometry` picks per call:
// - wgmma (m > 16): a block owns a 128 x BN output tile, BN 256 where
//   256-wide tiles number at least the SMs, else 128. One producer thread
//   keeps a ring of ~192 KB (4 or 6 stages), each a 128 x 128-byte x tile
//   and a BN x 128-byte weight tile, in flight by TMA (128-byte swizzle,
//   zeros out of bounds, one mbarrier per stage for "full" and one for
//   "empty"). Two consumer warpgroups of 64 rows each issue
//   wgmma.mma_async m64nBNk32 s8·s8 -> s32 from shared memory, keep one
//   stage's products in flight and release the stage before it. The
//   tile's bias and multipliers are staged while the first stages land,
//   and the int8 tile goes through shared memory (over stage 0) so that
//   global stores are coalesced. Bound: the operations, 2·M·N·K at 1979
//   TOP/s; a call of few k stages is bound by its fixed cost (~5 µs: the
//   first loads, the epilogue).
// - rows (m <= 16, a decode step): bound by the weight read, which 28
//   output tiles would leave to 28 SMs. A block owns 32 columns (112 or
//   more blocks at the model's decode shapes); its 8 warps take 128-byte
//   k chunks in turn, two in flight each, and load both operands of
//   mma.sync m16n8k32 s8·s8 straight from global memory, 16 bytes a
//   load, no shared memory: lane t holds the same 32 bytes of a chunk for
//   x and for w, so both fragments see the same permutation of k, and the
//   sum is exact. The warps add in shared memory and the block applies
//   the epilogue. K is not split across blocks: a split measured no
//   faster at any decode shape of the model (PERF.md §6).
//
// B7b (`matmul_ws_kernel`, kernel.py:55-70 and 113), `int8_matmul_ws_
// launch`: the paper's weight-stationary schedule in one launch. A block
// owns the partial sums of (its m range, 128 columns) for the whole call
// and walks the k tiles of bk in order. Per k tile, its (bk x 128) weight
// tile stays in shared memory while every 128-row tile of x in its m
// range streams past it in 64-byte chunks (mma.sync m16n8k32, 8 warps of
// 64 x 32). Each row tile reads its int32 partial sums from device memory
// (issued before its products, so the loads are in flight while they
// run), adds and writes them back: 2·4·M·N bytes per k tile, the paper's
// 2·N·D term and the reference's aliased `psum`, zeroed by the caller.
// The last k tile adds the bias and requantizes. Where the blocks
// outnumber the SMs and two fit an SM (bk <= 256), the partial sums land
// in shared memory by cp.async.cg, read back after a __syncthreads()
// (another thread wrote them a k tile before; the copy bypasses L1), and
// two blocks share each SM; otherwise each thread holds its fragment's
// partial sums in registers and reads back only what it wrote itself.
// The next weight tile lands by cp.async while the rows stream past the
// current one (the paper's W1/W2 double buffer) where two tiles fit;
// else one tile is loaded after the last row tile (bk up to 1664). The
// first x chunk of the next k tile is loaded during the last row tile.
// Bound: the partial-sum bytes. m ranges are sized by the caller
// (`kernel.ws_geometry`) to give ~8 blocks per SM where M allows; each
// range reads the weights once more. A decode step (one row tile) walks
// its k tiles one after another, each a partial-sum round trip.
//
// Epilogue (every kernel): __int2float_rn(acc + bias) (half to even above
// 2^24), __fmul_rn by the float32 multiplier, round half to even, clamp
// to [-128, 127] (`requant`); the int32 adds wrap, as XLA's. Every kernel
// equals the plain version bit for bit.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kMaxSmem = 232448;      // a block's shared memory on sm_90

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32, as XLA
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

// clip(round(f32(acc) · mult)) to int8. Clamping before rounding gives
// the same integer (the bounds are integers; a NaN clamps to -128 either
// way), and the clamped value plus 1.5·2^23 holds it, rounded half to
// even, in its low mantissa bits: an exact add in place of the
// quarter-rate rintf and float-to-int conversions.
__device__ __forceinline__ int8_t requant(int acc, float mult) {
  const float y = __fmul_rn(__int2float_rn(acc), mult);
  const float c = fminf(fmaxf(y, -128.f), 127.f);
  return static_cast<int8_t>(__float_as_int(__fadd_rn(c, 12582912.f)) -
                             0x4B400000);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// B7b: mma.sync tiles from shared memory
// ---------------------------------------------------------------------------

constexpr int kBM = 128;              // rows of a row tile
constexpr int kBN = 128;              // columns of a block
constexpr int kBK = 64;               // k bytes of an x chunk
constexpr int kThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kPad = 16;              // row padding of shared tiles (bytes)
constexpr int kAStride = kBK + kPad;  // x chunk row (bytes)

// An x chunk: kBM x kBK bytes = 2048 words, 8 per thread.
constexpr int kAWords = kBM * kBK / 4 / kThreads;

struct Acc {
  int c[4][4][4];                     // [m16 tile][n8 tile][fragment]
};

__device__ __forceinline__ unsigned lds(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Load the x chunk x[m0 : m0+kBM, k : k+kBK] (zero outside rows < m and
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

// acc += As[:, 0:kBK] · Bs[:, kb:kb+kBK]ᵀ over the warp's 64 x 32 part;
// Bs is the weight tile, column-major (row n holds its k bytes).
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

// Visit the thread's accumulator pairs: fn(row, col, mi, ni, h) for the
// output elements (row, col) and (row, col + 1) held in c[mi][ni][2h] and
// c[mi][ni][2h + 1], rows < m and columns < n only (n is a multiple of 4,
// so col + 1 < n too).
template <typename Fn>
__device__ __forceinline__ void for_each_pair(int m, int n, int m0, int n0,
                                              Fn fn) {
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
        if (row < m && col < n) fn(row, col, mi, ni, h);
      }
}

// The partial sums of the thread's fragment of the row tile at m0.
__device__ __forceinline__ void load_psum(Acc& ps, const int* psum, int m,
                                          int n, int m0, int n0) {
  zero(ps);
  for_each_pair(m, n, m0, n0, [&](int row, int col, int mi, int ni, int h) {
    const int2 p = __ldcg(reinterpret_cast<const int2*>(
        psum + static_cast<long long>(row) * n + col));
    ps.c[mi][ni][2 * h] = p.x;
    ps.c[mi][ni][2 * h + 1] = p.y;
  });
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// Start loading the weight tile of columns n0 + [0, kBN) and k bytes
// [k0, k0 + bkp) into bs (row r: column n0 + r, b_stride bytes), zeros at
// k >= k0 + bk or columns >= n; one cp.async group per thread. Pieces of
// 16 bytes where K and bk allow it (k0 then is a multiple of 16), else 4.
__device__ __forceinline__ void copy_w_tile(int8_t* bs, int b_stride,
                                            const int8_t* __restrict__ wt,
                                            int n, int kdim, int n0, int k0,
                                            int bk, int bkp, bool vec16) {
  const int piece = vec16 ? 16 : 4, pieces = bkp / piece;
  for (int i = threadIdx.x; i < kBN * pieces; i += kThreads) {
    const int r = i / pieces, k = piece * (i % pieces);
    const bool ok = n0 + r < n && k < bk;
    const int8_t* src =
        ok ? wt + static_cast<long long>(n0 + r) * kdim + k0 + k : wt;
    if (vec16)
      cp_async16(bs + r * b_stride + k, src, ok ? 16 : 0);
    else
      cp_async4(bs + r * b_stride + k, src, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

constexpr int kPsStride = kBN + 4;    // a staged partial-sum row (ints)
constexpr int kPsBytes = kBM * kPsStride * 4;
constexpr int kTwoBlocks = 115712;    // a block's shared memory, 2 per SM

// Start copying the partial sums of the row tile at m0 into ps (row r:
// psum row m0 + r, kPsStride ints; zeros outside rows < m, columns < n);
// one cp.async group per thread.
__device__ __forceinline__ void stage_psum(int* ps, const int* psum, int m,
                                           int n, int m0, int n0) {
  constexpr int kPieces = kBN / 4;     // 16-byte pieces of a row
  for (int i = threadIdx.x; i < kBM * kPieces; i += kThreads) {
    const int r = i / kPieces, c = 4 * (i % kPieces);
    const bool ok = m0 + r < m && n0 + c < n;
    const int* src =
        ok ? psum + static_cast<long long>(m0 + r) * n + n0 + c : psum;
    cp_async16(ps + r * kPsStride + c, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// B7b: grid (ceil(n / kBN), ceil(m / range_rows)). Shared memory: with
// kStaged the row tile's partial sums (kPsBytes; they land by cp.async
// while its products run, so no registers hold them and two blocks fit
// an SM), then one x chunk, then one or (double_w) two weight tiles of kBN
// rows of bkp + kPad bytes (bkp: bk rounded up to kBK, zero-filled).
// Without kStaged each thread loads its fragment's partial sums into
// registers instead (the tiles of a large bk leave no room for them).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? 2 : 1)
matmul_ws_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const int* __restrict__ bias, const float* __restrict__ mult,
                 int* psum, int8_t* __restrict__ out, int m, int n, int kdim,
                 int bk, int range_rows, int double_w) {
  extern __shared__ __align__(16) int8_t smem[];
  const int bkp = (bk + kBK - 1) / kBK * kBK, b_stride = bkp + kPad;
  int* const staged = reinterpret_cast<int*>(smem);
  int8_t* const as = smem + (kStaged ? kPsBytes : 0);
  int8_t* const w0 = as + kBM * kAStride;
  int8_t* const w1 = double_w ? w0 + kBN * b_stride : w0;
  const int n0 = blockIdx.x * kBN, r0 = blockIdx.y * range_rows;
  const int r1 = min(m, r0 + range_rows);
  const int chunks = bkp / kBK, steps = (r1 - r0 + kBM - 1) / kBM * chunks;
  const int nk = (kdim + bk - 1) / bk;
  const bool vec16 = kdim % 16 == 0 && bk % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  copy_w_tile(w0, b_stride, wt, n, kdim, n0, 0, min(bk, kdim), bkp, vec16);
  unsigned ra[kAWords];
  load_a(ra, x, m, kdim, r0, 0, min(bk, kdim));
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * bk, kend = min(kdim, k0 + bk);
    int8_t* const bs = kt & 1 ? w1 : w0;
    cp_async_wait_all();
    __syncthreads();                       // weight tile kt is resident
    if (double_w && kt + 1 < nk)           // W2 lands while rows pass W1
      copy_w_tile(kt & 1 ? w0 : w1, b_stride, wt, n, kdim, n0, kend,
                  min(bk, kdim - kend), bkp, vec16);
    const bool last = kt + 1 == nk;
    Acc acc, ps;
    for (int s = 0; s < steps; ++s) {
      const int m0 = r0 + s / chunks * kBM, kc = s % chunks * kBK;
      __syncthreads();                     // the last mma and RMW are done
      if (kc == 0) {                       // in flight during the products
        zero(acc);
        if constexpr (kStaged)
          stage_psum(staged, psum, m, n, m0, n0);
        else
          load_psum(ps, psum, m, n, m0, n0);
      }
      store_a(as, ra);
      __syncthreads();
      if (s + 1 < steps)                   // the next chunk, or the first
        load_a(ra, x, m, kdim, r0 + (s + 1) / chunks * kBM,  // of k tile
               k0 + (s + 1) % chunks * kBK, kend);           // kt + 1
      else if (!last)
        load_a(ra, x, m, kdim, r0, kend, min(kdim, kend + bk));
      mma_chunk(acc, as, bs, b_stride, kc);
      if (kc + kBK < bkp) continue;
      if constexpr (kStaged) {
        cp_async_wait_all();
        __syncthreads();                   // the staged partial sums
      }
      // read-add-write of the partial sums; the last k tile requantizes
      for_each_pair(m, n, m0, n0,
                    [&](int row, int col, int mi, int ni, int h) {
        const long long at = static_cast<long long>(row) * n + col;
        int2 p;
        if constexpr (kStaged)
          p = *reinterpret_cast<const int2*>(
              staged + (row - m0) * kPsStride + col - n0);
        else
          p = make_int2(ps.c[mi][ni][2 * h], ps.c[mi][ni][2 * h + 1]);
        p.x = wrap_add(p.x, acc.c[mi][ni][2 * h]);
        p.y = wrap_add(p.y, acc.c[mi][ni][2 * h + 1]);
        __stcg(reinterpret_cast<int2*>(psum + at), p);
        if (last) {
          char2 q;
          q.x = requant(wrap_add(p.x, bias[col]), mult[col]);
          q.y = requant(wrap_add(p.y, bias[col + 1]), mult[col + 1]);
          *reinterpret_cast<char2*>(out + at) = q;
        }
      });
    }
    if (!double_w && kt + 1 < nk) {
      __syncthreads();                     // every warp is done with W1
      copy_w_tile(w0, b_stride, wt, n, kdim, n0, kend, min(bk, kdim - kend),
                  bkp, vec16);
    }
  }
}

// ---------------------------------------------------------------------------
// B7a, rows geometry: mma.sync fragments loaded from global memory
// ---------------------------------------------------------------------------

constexpr int kRowsWarps = 8;         // warps of a block
constexpr int kRowsCols = 32;         // columns of a block: 4 n8 tiles
constexpr int kRowsMax = 16;          // rows the geometry takes (one m16)
constexpr int kChunk = 128;           // k bytes of a warp's step

__device__ __forceinline__ uint4 ld16(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// The weight is read once: stream it past L1.
__device__ __forceinline__ uint4 ld16_once(const int8_t* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// Word j (0..7) of 32 bytes held as two 16-byte loads.
__device__ __forceinline__ unsigned word(const uint4 (&v)[2], int j) {
  const uint4& h = v[j / 4];
  switch (j % 4) {
    case 0: return h.x;
    case 1: return h.y;
    case 2: return h.z;
    default: return h.w;
  }
}

// A lane's operands for one 128-byte k chunk: bytes 16t .. 16t+15 and
// 64+16t .. 64+16t+15 of the chunk (lane t = lane % 4), of x rows g and
// g + 8 and of the weight columns n0 + 8·ni + g (g = lane / 4). A warp's
// load covers 64 contiguous bytes of 8 rows.
struct RowsChunk {
  uint4 a0[2], a1[2], b[4][2];
};

struct RowsOperands {
  const int8_t* x0;                   // x row g (read only if lo)
  const int8_t* x1;                   // x row g + 8 (read only if hi)
  const int8_t* wt;
  int n, n0, ld;
  bool lo, hi;
};

__device__ __forceinline__ void rows_load(RowsChunk& r,
                                          const RowsOperands& o, int c,
                                          bool valid) {
  const int t = threadIdx.x % 4, g = threadIdx.x % 32 / 4;
  const int ka = c * kChunk + 16 * t, kb = ka + 64;
  const bool oka = valid && ka < o.ld, okb = valid && kb < o.ld;
  r.a0[0] = ld16(o.x0 + ka, o.lo && oka);
  r.a0[1] = ld16(o.x0 + kb, o.lo && okb);
  r.a1[0] = ld16(o.x1 + ka, o.hi && oka);
  r.a1[1] = ld16(o.x1 + kb, o.hi && okb);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = o.n0 + 8 * ni + g;
    const int8_t* p =
        o.wt + static_cast<long long>(col < o.n ? col : 0) * o.ld;
    r.b[ni][0] = ld16_once(p + ka, col < o.n && oka);
    r.b[ni][1] = ld16_once(p + kb, col < o.n && okb);
  }
}

// k32 step s takes words 2s and 2s + 1 of the lane's 32 bytes, of x and
// of w alike: the same permutation of k in both fragments.
__device__ __forceinline__ void rows_mma(int (&acc)[4][4],
                                         const RowsChunk& r) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const unsigned a[4] = {word(r.a0, 2 * s), word(r.a1, 2 * s),
                           word(r.a0, 2 * s + 1), word(r.a1, 2 * s + 1)};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const unsigned b[2] = {word(r.b[ni], 2 * s), word(r.b[ni], 2 * s + 1)};
      mma_s8(acc[ni], a, b);
    }
  }
}

// grid ceil(n / kRowsCols): block b owns columns 32b .. 32b + 31 and
// walks every k chunk.
__global__ void __launch_bounds__(kRowsWarps * 32, 2)
matmul_rows_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                   const int* __restrict__ bias, const float* __restrict__ mult,
                   int8_t* __restrict__ out, int m, int n, int ld) {
  __shared__ int red[kRowsWarps][kRowsMax][kRowsCols + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kRowsCols;
  const int chunks = (ld + kChunk - 1) / kChunk;
  const bool lo = g < m, hi = g + 8 < m;
  const RowsOperands o{x + static_cast<long long>(lo ? g : 0) * ld,
                       x + static_cast<long long>(hi ? g + 8 : 0) * ld,
                       wt, n, n0, ld, lo, hi};
  int acc[4][4] = {};
  int c = warp;
  RowsChunk cur, next;
  rows_load(cur, o, c, c < chunks);
  for (; c < chunks; c += kRowsWarps) {    // two chunks a warp in flight
    rows_load(next, o, c + kRowsWarps, c + kRowsWarps < chunks);
    rows_mma(acc, cur);
    cur = next;
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    red[warp][g][8 * ni + 2 * t] = acc[ni][0];
    red[warp][g][8 * ni + 2 * t + 1] = acc[ni][1];
    red[warp][g + 8][8 * ni + 2 * t] = acc[ni][2];
    red[warp][g + 8][8 * ni + 2 * t + 1] = acc[ni][3];
  }
  __syncthreads();
  constexpr int kPer = kRowsMax * kRowsCols / (kRowsWarps * 32);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kRowsWarps * 32;
    const int r = e / kRowsCols, col = n0 + e % kRowsCols;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w)
      v = wrap_add(v, red[w][r][e % kRowsCols]);
    if (r < m && col < n)
      out[r * n + col] = requant(wrap_add(v, bias[col]), mult[col]);
  }
}

// ---------------------------------------------------------------------------
// B7a, wgmma geometry: TMA ring, warp-specialized, wgmma s8·s8 -> s32
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;            // rows of a block tile (2 x 64)
constexpr int kWgBK = 128;            // k bytes of a stage: one swizzle row
constexpr int kWgThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kOutPad = 16;           // row padding of the int8 out tile

// A stage holds the x tile and the weight tile; the ring takes ~192 KB
// (4 stages at BN 256, 6 at 128).
template <int BN>
struct WgLayout {
  static constexpr int kA = kWgBM * kWgBK;           // x tile bytes
  static constexpr int kStage = kA + BN * kWgBK;     // + weight tile
  static constexpr int kStages = 192 * 1024 / kStage;
  // stages, 2 mbarriers a stage, the tile's bias and multipliers, slack
  // for 1024-byte alignment
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 8 * BN + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait of more than
// ~2^32 cycles (about two seconds) traps: a fault in a copy then ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1LL << 32)) __trap();
  } while (!done);
}

// Box (c0 = k byte, c1 = row) of `map` into shared memory at dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, b);
  else
    wgmma_n128(d, a, b);
}

// grid (ceil(m / kWgBM), ceil(n / BN)), m tiles fastest so that the
// blocks in flight share weight tiles in L2. tx: x (m, ld); tw: wt (n,
// ld).
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const int* __restrict__ bias,
                    const float* __restrict__ mult, int8_t* __restrict__ out,
                    int m, int n, int ld) {
  using L = WgLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      smem + L::kStages * L::kStage);
  uint64_t* const empty = full + L::kStages;
  int* const tile_bias = reinterpret_cast<int*>(empty + L::kStages);
  float* const tile_mult = reinterpret_cast<float*>(tile_bias + BN);
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * BN;
  const int nk = (ld + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {                 // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % L::kStages;
        if (kt >= L::kStages) mbar_wait(&empty[s], (kt / L::kStages - 1) & 1);
        uint8_t* const stage = smem + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        tma_load(stage, &tx, kt * kWgBK, m0, &full[s]);
        tma_load(stage + L::kA, &tw, kt * kWgBK, n0, &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;     // consumer: rows 64c .. 64c + 63
  const int tid = threadIdx.x % 128;
  // the epilogue's bias and multipliers, while the first stages land
  for (int i = threadIdx.x - 128; i < BN; i += 256) {
    const bool in = n0 + i < n;
    tile_bias[i] = in ? bias[n0 + i] : 0;
    tile_mult[i] = in ? mult[n0 + i] : 0.f;
  }
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % L::kStages;
    mbar_wait(&full[s], (kt / L::kStages) & 1);
    const uint32_t a = smem_addr(smem + s * L::kStage + c * 64 * kWgBK);
    const uint32_t b = smem_addr(smem + s * L::kStage + L::kA);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)
      wgmma_bn<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();                       // stage kt - 1 has been read
    fence_acc(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % L::kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every stage is read
  // epilogue: requantize into an int8 tile over stage 0, then store rows
  constexpr int kStride = BN + kOutPad;
  const int lane = tid % 32;
  uint8_t* const tile = smem + c * 64 * kStride;
  const int rl = 16 * (tid / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * (lane % 4);
    const int b0 = tile_bias[cl], b1 = tile_bias[cl + 1];
    const float f0 = tile_mult[cl], f1 = tile_mult[cl + 1];
    char2 lo, hi;
    lo.x = requant(wrap_add(acc[4 * j], b0), f0);
    lo.y = requant(wrap_add(acc[4 * j + 1], b1), f1);
    hi.x = requant(wrap_add(acc[4 * j + 2], b0), f0);
    hi.y = requant(wrap_add(acc[4 * j + 3], b1), f1);
    *reinterpret_cast<char2*>(tile + rl * kStride + cl) = lo;
    *reinterpret_cast<char2*>(tile + (rl + 8) * kStride + cl) = hi;
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + c) : "memory");
  constexpr int kWords = BN / 4;
  for (int i = tid; i < 64 * kWords; i += 128) {
    const int r = i / kWords, cw = i % kWords;
    const int row = m0 + 64 * c + r, col = n0 + 4 * cw;
    if (row < m && col < n)
      *reinterpret_cast<unsigned*>(out + static_cast<long long>(row) * n +
                                   col) =
          *reinterpret_cast<const unsigned*>(tile + r * kStride + 4 * cw);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link to libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
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

// A map of `rows` rows of ld int8 (ld bytes apart) in boxes of box_rows x
// kWgBK bytes, 128-byte swizzle, zeros out of bounds.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int ld,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {kWgBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_wgmma(const void* x, const void* wt, const void* bias,
                 const void* mult, void* out, int m, int n, int ld,
                 cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, m, ld, kWgBM) || !tensor_map(&tw, wt, n, ld, BN))
    return static_cast<int>(cudaErrorNotSupported);
  const int smem = WgLayout<BN>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kWgBM - 1) / kWgBM, (n + BN - 1) / BN);
  matmul_wgmma_kernel<BN><<<grid, kWgThreads, smem, stream>>>(
      tx, tw, static_cast<const int*>(bias), static_cast<const float*>(mult),
      static_cast<int8_t*>(out), m, n, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B7a. x (m, ld) int8 and wt (n, ld) int8, the weight K-major, both
// 16-byte aligned with ld a multiple of 16 (columns past K zero); bias
// (n,) int32, mult (n,) f32 -> out (m, n) int8; n a multiple of 4. The
// geometry is `kernel.matmul_geometry`'s: bn 256 or 128 takes the wgmma
// kernel with bn-wide tiles; bn 0 the rows kernel (m <= 16). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int int8_matmul_launch(const void* x, const void* wt,
                                  const void* bias, const void* mult,
                                  void* out, int m, int n, int ld, int bn,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (ld <= 0 || ld % 16 || n % 4 || !aligned(x, 16) || !aligned(wt, 16) ||
      !aligned(out, 4) || (bn == 0 && m > kRowsMax) ||
      (bn != 0 && bn != 128 && bn != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return launch_wgmma<256>(x, wt, bias, mult, out, m, n, ld, st);
  if (bn == 128)
    return launch_wgmma<128>(x, wt, bias, mult, out, m, n, ld, st);
  matmul_rows_kernel<<<(n + kRowsCols - 1) / kRowsCols, kRowsWarps * 32, 0,
                       st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(bias), static_cast<const float*>(mult),
      static_cast<int8_t*>(out), m, n, ld);
  return static_cast<int>(cudaGetLastError());
}

// B7b, one call: psum (m, n) int32, zeroed by the caller, += x · w over
// the k tiles of bk in order; on the last, out (m, n) int8 =
// requant(psum + bias). x (m, kdim) row-major and wt (n, kdim), the weight
// K-major, 4-byte aligned; kdim, n and bk multiples of 4; psum 16-byte
// aligned; the geometry is `kernel.ws_geometry`'s: range_rows a multiple
// of 128, the rows of a block's m range; staged (the row tile's partial
// sums in shared memory, two blocks to an SM) and double_w (two weight
// tiles) as it picks them, refused where they do not fit.
extern "C" int int8_matmul_ws_launch(const void* x, const void* wt,
                                     const void* bias, const void* mult,
                                     void* psum, void* out, int m, int n,
                                     int kdim, int bk, int range_rows,
                                     int staged, int double_w,
                                     void* stream) {
  if (m <= 0 || n <= 0 || range_rows <= 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + range_rows - 1) / range_rows);
  const int bkp = (bk + kBK - 1) / kBK * kBK;
  const int tile = kBN * (bkp + kPad), chunk = kBM * kAStride;
  const int smem =
      chunk + (staged ? kPsBytes : 0) + (double_w ? 2 : 1) * tile;
  if (bk <= 0 || bk % 4 || kdim <= 0 || kdim % 4 || n % 4 ||
      smem > (staged ? kTwoBlocks : kMaxSmem) || range_rows % kBM ||
      !aligned(x, 4) || !aligned(wt, 4) || !aligned(psum, 16) ||
      !aligned(out, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = staged ? matmul_ws_kernel<true>
                             : matmul_ws_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(bias), static_cast<const float*>(mult),
      static_cast<int*>(psum), static_cast<int8_t*>(out), m, n, kdim, bk,
      range_rows, double_w);
  return static_cast<int>(cudaGetLastError());
}
