// ITA onepass attention for Hopper: replaces the Pallas `onepass_kernel`
// behind `ita_attention_onepass` (B2) and `ita_attention_onepass_paged`
// (B3) (src/repro/kernels/ita_attention/kernel.py:79-130, 265-315,
// 516-564): int8 Q·Kᵀ -> int32 -> requant onto the int8 logit grid, the
// streaming DA step per KV tile (running max, Σ, u = 128 >> k),
// acc = acc·2^-δ + u·V, and DI at the end folded into the int8 output
// requant.
//
// What bounds it. Once the q heads that share a kv head read a K/V tile
// together, the work per K/V byte is high (2·rows·d integer ops per K/V
// token), and the tensor cores take the products; what is left is the
// scalar DA step (about 15 integer and float32 instructions per logit)
// and the latency of each block's chain of KV tiles, which no other
// block can shorten: the tiles of a row run in order in one block. The
// first port (ita_common.cuh's `attend_rows`, which now serves only the
// decode kernel) did its products on the scalar pipe (Q·Kᵀ by __dp4a,
// u·V by an int32 loop from shared memory), ran one block per (q row, 16
// queries), so each of the kv_rep q heads of a kv head staged the same
// K/V tile again, and paid for 15 dead query rows of every 16 in a
// decode call.
//
// This design:
// - Packing. One block serves one kv row (the kv_rep q rows that read
//   the same K/V) and a tile of packed rows, query-major: packed row m
//   is query i = m / kv_rep of head h = m % kv_rep. One K/V tile in
//   shared memory serves every head, and a decode call fills 7 of 16
//   rows (qwen2-7b's 28/4 heads) instead of 1. Every packed row keeps
//   its own meta (kv_len, q_offset, q_len) and multipliers; the block
//   walks the union of its rows' KV tile ranges, in order, and a tile
//   outside a row's range is an exact no-op of DA for that row (δ 0,
//   u 0, correction 1.0), so each row sees the plain version's schedule.
// - Warps. Row groups of 16 packed rows, WN warps each: in Q·Kᵀ and DA a
//   warp takes a slice of the tile's keys, in u·V a slice of the head
//   dim. The row max and Σ of a tile meet in shared memory behind a
//   barrier of the group's warps. The launch picks (rows, WN) for the
//   call (`geometry`): 16 rows and 8 warps for a decode step (one live
//   row group: all warps on its keys), 64 rows and 2 warps when the call
//   has blocks enough to fill the card twice (the SMs' instruction rate
//   binds, and a K/V tile is shared by the most rows), else 32 rows and 4
//   warps (twice the blocks, shorter chains).
// - Q·Kᵀ on tensor cores: mma.sync m16n8k32 s8·s8 -> s32, operands by
//   ldmatrix from the Q tile and the token-major K tile. The int32 sum is
//   exact, so its order does not matter.
// - DA on the accumulator fragments with the helpers of ita_common.cuh
//   (da_delta, da_shift with kMaskK, Σ in int32); the requant onto the
//   logit grid and the int -> float conversions use exact magic-number
//   adds on the full-rate pipes instead of I2F/F2I/FRND.
// - u·V on tensor cores: u in [0, 128] is u8, V is s8, mma.sync
//   m16n8k32 u8·s8 -> s32 (the reference packs u into uint8 for the MXU
//   the same way). V stays token-major: ldmatrix.trans of 16-bit pairs
//   and two __byte_perm give the d-major B operands, with the keys of
//   each 16-key group in the order {2t, 2t+1, 8+2t, 9+2t} for lane t; u
//   is stored into the u tile in that same order, so the sum is the same
//   set of products. |u·V| <= 2^22 per tile, exact in int32 and float32;
//   then acc = acc·2^-δ + u·V per element, in the plain version's order.
// - Copies: K, V (and once Q) land by cp.async.cg (16 bytes) in a
//   two-stage ring, so tile j+1 loads while tile j computes (one stage
//   when two do not fit, as at head dim 256 with 256-key tiles). The
//   paged reader loads a tile's page id once per tile (tile == page).
//   Without a window, tile 0 and Q load while the block works out its
//   KV range.
//
// KV is never split across blocks (the integer Σ shifts make the result
// depend on the tile boundaries). Bit-exactness: the rounding helpers of
// ita_common.cuh (rintf, __fmul_rn, powers of two from exponent bits)
// and exact conversions.
#include "ita_common.cuh"

namespace {

constexpr int kMaxTile = 256;       // keys per KV tile
constexpr int kManyBlocks = 4 * 132;  // 64-row blocks: 2 waves of 2 a SM
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr int kInvalid = -1000;     // a masked logit (below kNegSentinel)

// Shared memory of one block: `stages` K and V staging tiles and the Q
// tile (rows of d + 16 bytes: 16-byte ldmatrix rows hit distinct banks,
// and the zeroed pad of a Q row is the upper half of the last k32 step
// when d is 16 mod 32), the u tile (rows of sp + 16 bytes; sp: the
// tile's keys rounded up to the 32 of an mma step), the row groups'
// partial maxima and sums, and the block's KV tile range.
struct Layout {
  int ks, sp, us, stage, kv, q, u, red, range, bytes;
};

__host__ __device__ inline Layout layout(int d, int bkv, int stages,
                                         int rows, int wn) {
  Layout l;
  l.ks = d + 16;
  l.sp = (bkv + 31) / 32 * 32;
  l.us = l.sp + 16;
  l.stage = 2 * l.sp * l.ks;
  l.kv = 0;
  l.q = l.kv + stages * l.stage;
  l.u = l.q + rows * l.ks;
  l.red = l.u + rows * l.us;
  l.range = l.red + 2 * wn * rows * 4;
  l.bytes = l.range + 16;
  return l;
}

// Two stages where they fit, else one; 0 when neither does.
inline int stages_for(int d, int bkv, int rows, int wn) {
  for (int s = 2; s >= 1; --s)
    if (layout(d, bkv, s, rows, wn).bytes <= kMaxSmem) return s;
  return 0;
}

// x / n and x % n by a shift and a mask when n is a power of two.
struct Div {
  int n, shift;
  __device__ explicit Div(int n_) : n(n_), shift(0) {
    while ((1 << shift) < n) ++shift;
    if ((1 << shift) != n) shift = -1;
  }
  __device__ __forceinline__ int quo(int x) const {
    return shift >= 0 ? x >> shift : x / n;
  }
  __device__ __forceinline__ int rem(int x) const {
    return shift >= 0 ? x & (n - 1) : x % n;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The WN warps of row group `id - 1` meet.
template <int WN>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * WN) : "memory");
}

// Four 8 x 16-byte matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and gets, of each matrix, bytes 4t..4t+3 of row g.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed as 16-bit pairs: of each matrix, bytes 2g, 2g+1
// of rows 2t and 2t+1.
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exact conversions on the full-rate pipes (I2F, F2I and FRND run at a
// quarter of the rate on sm_90, and the DA step takes three of them per
// logit). kMagic = 1.5·2^23: floats in [2^23, 2^24] are spaced by 1, so
// - int -> float: __int_as_float(x + bits(kMagic)) - kMagic == (float)x
//   for |x| <= 2^22 (|Q·K| <= 128·128·256 and |u·V| <= 128·128·256 are);
// - float -> nearest int, ties to even: __float_as_int(y + kMagic) -
//   bits(kMagic) == (int)rintf(y) for |y| <= 2^22 (the add rounds y to
//   an integer half to even, as rintf).
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float exact_float(int x) {
  return __fsub_rn(__int_as_float(x + kMagicBits), kMagic);
}

// ita::requant_logit, clamped before it rounds (rint and the clamp to
// [-128, 127] commute), which keeps the rounding operand within 2^22.
__device__ __forceinline__ int requant_logit(int acc, float lmult) {
  const float y =
      fminf(fmaxf(__fmul_rn(exact_float(acc), lmult), -128.f), 127.f);
  return __float_as_int(__fadd_rn(y, kMagic)) - kMagicBits;
}

// Where the u of key p (0..15) of a 16-key group sits in the u tile: the
// k order {2t, 2t+1, 8+2t, 9+2t} of lane t that ldmatrix.trans gives V.
__device__ __forceinline__ int u_slot(int p) {
  return 4 * ((p & 7) >> 1) + 2 * (p >> 3) + (p & 1);
}

// One packed row of the block: where it reads and what it may see.
struct Row {
  int r, i;          // kernel row and query index; r < 0: no such row
  int qi, q_len, kv_len;
  float lm, om;
  __device__ bool live() const { return r >= 0 && i < q_len; }
};

__device__ __forceinline__ Row packed_row(int kr, int m, int sq, int kv_rep,
                                          const int* meta,
                                          const float* lmult,
                                          const float* omult) {
  Row w{-1, 0, 0, 0, 0, 0.f, 0.f};
  const int i = m / kv_rep;
  if (i >= sq) return w;
  w.r = kr * kv_rep + m % kv_rep;
  w.i = i;
  w.kv_len = meta[3 * w.r];
  w.qi = meta[3 * w.r + 1] + i;
  w.q_len = meta[3 * w.r + 2];
  w.lm = lmult[w.r];
  w.om = omult[w.r];
  return w;
}

// KV tile range [begin, end) that can hold a key visible to the row.
__device__ __forceinline__ void row_range(const Row& w, int skv, int bkv,
                                          int causal, int window, int* begin,
                                          int* end) {
  *begin = 0;
  *end = 0;
  if (!w.live()) return;
  int e = min((w.kv_len + bkv - 1) / bkv, skv / bkv);
  if (causal || window > 0) e = min(e, w.qi / bkv + 1);
  *end = e;
  if (window > 0) *begin = max(w.qi - window + 1, 0) / bkv;
}

// The keys [lo, hi) of tile j (offsets in the tile) the row sees: ita::
// visible as an interval.
__device__ __forceinline__ void row_keys(const Row& w, int j, int bkv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  const int base = j * bkv;
  int h = w.live() ? min(w.kv_len - base, bkv) : 0;
  if (causal || window > 0) h = min(h, w.qi + 1 - base);
  *hi = h;
  *lo = window > 0 ? w.qi - window + 1 - base : 0;
}

// One block: kv row kr (q rows kr·kv_rep + h) and a tile of kRows packed
// rows, the tiles of the latest queries (the most KV tiles) first. Warp
// (wm, wn): packed rows 16·wm .. +16; keys wn·SMAX/WN .. of a tile in
// Q·Kᵀ and DA, head-dim columns wn·DMAX/WN .. in u·V. DMAX bounds the
// head dim, SMAX the KV tile.
template <int DMAX, int SMAX, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
onepass_kernel(const int8_t* __restrict__ q, const ita::KvOperand kv,
               const float* __restrict__ lmult,
               const float* __restrict__ omult, const int* __restrict__ meta,
               int8_t* __restrict__ out, int sq, int bkv, int causal,
               int window, int adaptive, int n_mt, int stages) {
  constexpr int kRows = 16 * WM;            // packed rows per block
  constexpr int kBlockThreads = 32 * WM * WN;
  constexpr int NTW = SMAX / WN / 8;        // n8 key tiles of a warp
  constexpr int NG = DMAX / WN / 16;        // 16-column head-dim groups
  static_assert(NTW % 2 == 0 && NG >= 1, "warp tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = kv.d;
  const Layout L = layout(d, bkv, stages, kRows, WN);
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + L.q);
  int8_t* s_u = reinterpret_cast<int8_t*>(smem + L.u);
  int* s_max = reinterpret_cast<int*>(smem + L.red);
  int* s_sum = s_max + WN * kRows;
  int* s_range = reinterpret_cast<int*>(smem + L.range);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_kr = gridDim.x / n_mt;
  const int kr = blockIdx.x % n_kr;
  const int m0 = (n_mt - 1 - blockIdx.x / n_kr) * kRows;
  const int dk = (d + 31) / 32, nk = L.sp / 32;
  const Div d16(d / 16);

  // K/V addressing: tile j of kv row kr starts at `base`, tokens `tok`
  // bytes apart (3D ring: row kr; 4D ring and pool: head kr % g of batch
  // row kr / g; pool: page page_table[kr / g, j], loaded once a tile).
  const long long tok = kv.kv_4d ? static_cast<long long>(kv.g) * d : d;
  auto tile_base = [&](int j) -> long long {
    if (kv.page_table != nullptr) {
      const long long phys = kv.page_table[(kr / kv.g) * kv.n_pages + j];
      return (phys * kv.page * kv.g + kr % kv.g) * d;
    }
    if (kv.kv_4d)
      return ((static_cast<long long>(kr / kv.g) * kv.skv + j * bkv) * kv.g +
              kr % kv.g) * d;
    return (static_cast<long long>(kr) * kv.skv + j * bkv) * d;
  };
  auto load_tile = [&](int j, int stage) {
    int8_t* s_k = reinterpret_cast<int8_t*>(smem + L.kv + stage * L.stage);
    int8_t* s_v = s_k + L.sp * L.ks;
    const long long base = tile_base(j);
    for (int idx = tid; idx < bkv * d16.n; idx += kBlockThreads) {
      const int tk = d16.quo(idx), c = d16.rem(idx);
      const long long off = base + tk * tok + c * 16;
      cp_async16(s_k + tk * L.ks + c * 16, kv.k + off);
      cp_async16(s_v + tk * L.ks + c * 16, kv.v + off);
    }
  };
  // The Q tile: packed row m is q[r, i]; rows past sq and the pad bytes
  // of every row are zero.
  auto load_q = [&]() {
    for (int idx = tid; idx < kRows * (d16.n + 1); idx += kBlockThreads) {
      const int mr = idx / (d16.n + 1), c = idx % (d16.n + 1);
      const int m = m0 + mr, i = m / kv.kv_rep;
      int8_t* dst = s_q + mr * L.ks + c * 16;
      if (c < d16.n && i < sq) {
        const int r = kr * kv.kv_rep + m % kv.kv_rep;
        cp_async16(dst,
                   q + (static_cast<long long>(r) * sq + i) * d + c * 16);
      } else {
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
      }
    }
  };
  // Without a window every row's range starts at tile 0: its load (and
  // Q's) goes out before the range is known.
  if (window == 0) {
    load_q();
    load_tile(0, 0);
    cp_async_commit();
  }

  // The block's KV tile range: the union of its rows' ranges.
  if (tid == 0) {
    s_range[0] = 1 << 30;
    s_range[1] = 0;
  }
  __syncthreads();
  if (tid < kRows) {
    const Row w = packed_row(kr, m0 + tid, sq, kv.kv_rep, meta, lmult, omult);
    int b, e;
    row_range(w, kv.skv, bkv, causal, window, &b, &e);
    if (b < e) {
      atomicMin(&s_range[0], b);
      atomicMax(&s_range[1], e);
    }
  }
  __syncthreads();
  const int j_begin = s_range[0], j_end = s_range[1];
  if (window > 0 && j_begin < j_end) {
    load_q();
    load_tile(j_begin, 0);
    cp_async_commit();
  }

  // This thread's two packed rows: g and g + 8 of its row group.
  const int row0 = 16 * wm + g;
  Row rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rows[h] = packed_row(kr, m0 + row0 + 8 * h, sq, kv.kv_rep, meta, lmult,
                         omult);
  // the warps of a row group hold the same rows
  const bool group_live =
      __any_sync(0xffffffffu, rows[0].live() || rows[1].live());
  // ldmatrix row addresses of this lane: A operands (Q, u) take rows
  // 16·wm + (l/8 % 2)·8 + l % 8 at byte (l/16)·16 of a k32 step; K takes
  // keys (l/16)·8 + l % 8 at byte (l/8 % 2)·16; V takes keys (l/8)·8 +
  // l % 8 of a k32 step.
  const int a_row = 16 * wm + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_col = (lane >> 4) * 16;
  const int k_key = (lane >> 4) * 8 + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 16;
  const int v_key = (lane >> 3) * 8 + (lane & 7);

  float acc[NG][2][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][h][e] = 0.f;
  int m_run[2] = {ita::kNegSentinel, ita::kNegSentinel};
  int sigma[2] = {0, 0};

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = stages == 2 ? (j - j_begin) & 1 : 0;
    const int8_t* s_k =
        reinterpret_cast<const int8_t*>(smem + L.kv + stage * L.stage);
    const int8_t* s_v = s_k + L.sp * L.ks;
    cp_async_wait_all();
    __syncthreads();            // tile j landed; every warp is done with j-1
    if (stages == 2 && j + 1 < j_end) {
      load_tile(j + 1, stage ^ 1);  // in flight while tile j computes
      cp_async_commit();
    }
    if (group_live) {
      // S = Q·Kᵀ for the group's 16 rows and the warp's keys
      int s[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0;
#pragma unroll
      for (int kk = 0; kk < DMAX / 32; ++kk) {
        if (kk >= dk) break;
        unsigned a[4];
        ldsm4(a, s_q + a_row * L.ks + kk * 32 + a_col);
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          const int key0 = (wn * NTW + 2 * np) * 8;
          if (key0 < bkv) {
            unsigned b[4];
            ldsm4(b, s_k + (key0 + k_key) * L.ks + kk * 32 + k_col);
            mma_s8s8(s[2 * np], a, b[0], b[1]);
            mma_s8s8(s[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      // requant and mask, partial row maxima
      int lo[2], hi[2], mx[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_keys(rows[h], j, bkv, causal, window, &lo[h], &hi[h]);
        mx[h] = ita::kNegSentinel;
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int col = (wn * NTW + nt) * 8 + 2 * t + e % 2;
          const bool ok = col >= lo[h] && col < hi[h];
          s[nt][e] = ok ? requant_logit(s[nt][e], rows[h].lm) : kInvalid;
          mx[h] = max(mx[h], s[nt][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (t == 0) s_max[wn * kRows + row0 + 8 * h] = mx[h];
      }
      group_sync<WN>(1 + wm);
      // DA: the new max, u into the u tile, partial sums
      int new_max[2], usum[2] = {0, 0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int part = ita::kNegSentinel;
#pragma unroll
        for (int w = 0; w < WN; ++w)
          part = max(part, s_max[w * kRows + row0 + 8 * h]);
        new_max[h] = max(m_run[h], part);
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, x = s[nt][e];
          s[nt][e] = 128 >> ita::da_shift(new_max[h], x, x != kInvalid);
          usum[h] += s[nt][e];
        }
        const int key = (wn * NTW + nt) * 8;     // n8 tile's first key
        if (key < L.sp) {
          const int slot = (key & ~15) + u_slot((key & 8) + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<unsigned short*>(
                s_u + (row0 + 8 * h) * L.us + slot) =
                static_cast<unsigned short>(s[nt][2 * h] |
                                            (s[nt][2 * h + 1] << 8));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        usum[h] += __shfl_xor_sync(0xffffffffu, usum[h], 1);
        usum[h] += __shfl_xor_sync(0xffffffffu, usum[h], 2);
        if (t == 0) s_sum[wn * kRows + row0 + 8 * h] = usum[h];
      }
      group_sync<WN>(1 + wm);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < WN; ++w)
          total += s_sum[w * kRows + row0 + 8 * h];
        const int delta = ita::da_delta(new_max[h], m_run[h]);
        sigma[h] = (sigma[h] >> delta) + 2 * total;
        m_run[h] = new_max[h];
        corr[h] = ita::pow2_neg(delta);
      }
      // u·V over the tile's keys for the warp's head-dim columns: per 16
      // columns d0.., ldmatrix.trans gives lane (g, t) bytes 2g, 2g+1 of
      // keys 2t, 2t+1 (and 8+2t, 9+2t); __byte_perm splits them into the
      // B operands of columns d0 + 2g (tile 0) and d0 + 2g + 1 (tile 1).
      int pv[NG][2][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][h][e] = 0;
#pragma unroll
      for (int ks = 0; ks < SMAX / 32; ++ks) {
        if (ks >= nk) break;
        unsigned a[4];
        ldsm4(a, s_u + a_row * L.us + ks * 32 + a_col);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int d0 = (wn * NG + n) * 16;
          if (d0 < d) {
            unsigned r[4];
            ldsm4_t(r, s_v + (ks * 32 + v_key) * L.ks + d0);
            mma_u8s8(pv[n][0], a, __byte_perm(r[0], r[1], 0x6420),
                     __byte_perm(r[2], r[3], 0x6420));
            mma_u8s8(pv[n][1], a, __byte_perm(r[0], r[1], 0x7531),
                     __byte_perm(r[2], r[3], 0x7531));
          }
        }
      }
      // acc = acc·2^-δ + u·V, per element
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][h][e] = __fadd_rn(__fmul_rn(acc[n][h][e], corr[e / 2]),
                                     exact_float(pv[n][h][e]));
    }
    if (stages == 1 && j + 1 < j_end) {
      __syncthreads();          // every warp is done with the one stage
      load_tile(j + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait_all();          // a speculative load of an empty range

  // DI once per row, folded into the output requant; rows without a
  // visible key (past q_len, or an empty range) output 0. Lane (g, t)
  // holds columns d0 + 4t .. d0 + 4t + 3 of each 16-column group.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Row& w = rows[h];
    if (w.r < 0) continue;
    int inv, e_r;
    if (adaptive)
      ita::adaptive_inverse(sigma[h], &inv, &e_r);
    else
      ita::paper_inverse(sigma[h], &inv, &e_r);
    const float scale = ita::out_scale(inv, e_r, w.om);
    int8_t* dst = out + (static_cast<long long>(w.r) * sq + w.i) * d + 4 * t;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int d0 = (wn * NG + n) * 16;
      if (d0 < d) {
        char4 v;
        v.x = ita::requant_out(acc[n][0][2 * h], scale);
        v.y = ita::requant_out(acc[n][1][2 * h], scale);
        v.z = ita::requant_out(acc[n][0][2 * h + 1], scale);
        v.w = ita::requant_out(acc[n][1][2 * h + 1], scale);
        *reinterpret_cast<char4*>(dst + d0) = v;
      }
    }
  }
}

// The block geometry for a call: (WM, WN) by what binds it. A call with
// at most 16 packed rows per kv row (a decode step) has one live row
// group, so all 8 warps split the keys; a call with many blocks is bound
// by the SMs' instruction rate, so 64-row blocks share each K/V tile
// among the most rows; otherwise 32-row blocks (twice the blocks)
// shorten each block's chain of KV tiles. KV tiles over 128 keys take
// (2, 4).
struct Geometry {
  int wm, wn, rows, stages, smem, n_mt, blocks;
};

inline Geometry geometry(int bh, int sq, int d, int bkv, int kv_rep) {
  Geometry g{};
  const long long packed = static_cast<long long>(sq) * kv_rep;
  const int n_kr = bh / kv_rep;
  if (bkv > 128) {
    g.wm = 2;
  } else if (packed <= 16) {
    g.wm = 1;
  } else {
    g.wm = n_kr * ((packed + 63) / 64) >= kManyBlocks ? 4 : 2;
  }
  // 8 warps; 4 for a decode step at d <= 64 (a warp takes >= 16 columns)
  g.wn = g.wm == 1 && d <= 64 ? 4 : 8 / g.wm;
  g.rows = 16 * g.wm;
  g.stages = stages_for(d, bkv, g.rows, g.wn);
  g.smem = g.stages ? layout(d, bkv, g.stages, g.rows, g.wn).bytes : 0;
  g.n_mt = static_cast<int>((packed + g.rows - 1) / g.rows);
  g.blocks = n_kr * g.n_mt;
  return g;
}

template <int DMAX, int SMAX, int WM, int WN>
int launch_t(const void* q, const ita::KvOperand& kv, const void* lmult,
             const void* omult, const void* meta, void* out, int sq, int bkv,
             int causal, int window, int adaptive, const Geometry& g,
             cudaStream_t stream) {
  auto* kernel = onepass_kernel<DMAX, SMAX, WM, WN>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (g.blocks == 0) return 0;
  kernel<<<g.blocks, 32 * WM * WN, g.smem, stream>>>(
      static_cast<const int8_t*>(q), kv, static_cast<const float*>(lmult),
      static_cast<const float*>(omult), static_cast<const int*>(meta),
      static_cast<int8_t*>(out), sq, bkv, causal, window, adaptive, g.n_mt,
      g.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_d(const void* q, const ita::KvOperand& kv, const void* lmult,
             const void* omult, const void* meta, void* out, int sq, int bkv,
             int causal, int window, int adaptive, const Geometry& g,
             cudaStream_t st) {
  constexpr int kDecodeWN = DMAX <= 64 ? 4 : 8;
  if (bkv > 128)
    return launch_t<DMAX, 256, 2, 4>(q, kv, lmult, omult, meta, out, sq, bkv,
                                     causal, window, adaptive, g, st);
  if (g.wm == 1 && g.wn == kDecodeWN)
    return launch_t<DMAX, 128, 1, kDecodeWN>(q, kv, lmult, omult, meta, out,
                                             sq, bkv, causal, window,
                                             adaptive, g, st);
  if (g.wm == 4)
    return launch_t<DMAX, 128, 4, 2>(q, kv, lmult, omult, meta, out, sq, bkv,
                                     causal, window, adaptive, g, st);
  return launch_t<DMAX, 128, 2, 4>(q, kv, lmult, omult, meta, out, sq, bkv,
                                   causal, window, adaptive, g, st);
}

// Head dim a multiple of 16 up to 256, KV tile up to 256 keys, bh a
// multiple of kv_rep; geometry as `kernel.onepass_geometry`.
int launch(const void* q, const ita::KvOperand& kv, const void* lmult,
           const void* omult, const void* meta, void* out, int bh, int sq,
           int bkv, int causal, int window, int adaptive, void* stream) {
  const int d = kv.d;
  if (d <= 0 || d % 16 || d > ita::kMaxHeadDim || bkv <= 0 ||
      bkv > kMaxTile || kv.kv_rep <= 0 || bh % kv.kv_rep)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(bh, sq, d, bkv, kv.kv_rep);
  if (g.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_d<64>(q, kv, lmult, omult, meta, out, sq, bkv, causal,
                        window, adaptive, g, st);
  if (d <= 128)
    return launch_d<128>(q, kv, lmult, omult, meta, out, sq, bkv, causal,
                         window, adaptive, g, st);
  return launch_d<256>(q, kv, lmult, omult, meta, out, sq, bkv, causal,
                       window, adaptive, g, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_onepass_launch(const void* q, const void* k, const void* v,
                                  const void* lmult, const void* omult,
                                  const void* meta, void* out, int bh, int sq,
                                  int skv, int d, int bkv, int kv_4d,
                                  int kv_rep, int hq, int g, int causal,
                                  int window, int adaptive, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), skv, d, kv_rep, hq,
                          g, kv_4d};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, bkv, causal, window,
                adaptive, stream);
}

// Paged: k/v pools (P, page, G, d), page_table (bh / hq, n_pages) int32.
extern "C" int ita_onepass_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lmult, const void* omult,
    const void* meta, void* out, int bh, int sq, int n_pages, int page,
    int d, int kv_rep, int hq, int g, int causal, int window, int adaptive,
    void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k_pool),
                          static_cast<const int8_t*>(v_pool),
                          n_pages * page, d, kv_rep, hq, g, 1,
                          static_cast<const int*>(page_table), n_pages,
                          page};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, page, causal, window,
                adaptive, stream);
}
