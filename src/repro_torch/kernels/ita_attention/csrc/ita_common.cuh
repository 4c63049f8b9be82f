// Shared device code of the ITA attention kernels for Hopper (sm_90a).
//
// Replaces the body shared by the Pallas kernels `onepass_kernel` and
// `decode_kernel` (src/repro/kernels/ita_attention/kernel.py:79-130,
// 185-231) and their helpers in src/repro/kernels/common.py:113-190:
// int8 Q·Kᵀ -> int32 -> requant onto the int8 logit grid, the streaming
// DA step (running max, Σ, u = 128 >> k), acc = acc·2^-δ + u·V, and DI at
// the last tile folded into the int8 output requant.
//
// The scalar helpers (requant, DA shifts, DIs, powers of two, the K/V
// operand), the packed rows with their tile ranges and the mma.sync,
// ldmatrix and cp.async helpers serve every attention kernel, the
// twopass kernels (twopass.cu) among them. `attend_block` is the
// tensor-core block of the onepass kernel (onepass.cu: B2, B3) and the
// decode kernel (decode.cu: B4, B4p), with the cluster helpers:
// - one block serves one kv row (the kv_rep q rows that read the same
//   K/V) and a tile of packed (query, head) rows in row groups of 16;
// - Q·Kᵀ and u·V on mma.sync m16n8k32 (s8·s8 and u8·s8 -> s32), DA on
//   the accumulator fragments;
// - K/V land by cp.async in a ring of stages, or, in a cluster, each CTA
//   holds its run of the kv row's tiles and the CTAs fold the tiles in
//   order through distributed shared memory.
// Integer Σ shifts make the result depend on the KV tile boundaries and
// on the order of the f32 fold, so both stay the plain version's: a row
// is never split into blocks that fold on their own.
//
// Bit-exactness with the JAX package: round half to even (rintf, or the
// exact magic-number adds), every product that feeds a rounding is an
// explicit __fmul_rn (no contraction), powers of two are built from
// exponent bits, shifts are taken only on non-negative operands and
// amounts in [0, 31].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ita {

constexpr int kNegSentinel = -256;   // masked-logit fill
constexpr int kMaskK = 31;           // shift of a masked element: 128 >> 31 == 0
constexpr int kSoftmaxShift = 5;
constexpr int kSigmaInvMax = 256;
constexpr int kPaperInvMax = 1 << 16;
constexpr int kMaxHeadDim = 256;

// K/V operand: a ring in the kernel layout (BH/kv_rep, S, D) or the
// cache-native layout (B, S, G, D), or a paged pool (P, page, G, D) read
// through a per-sequence page table (B, n_pages). Every K/V address goes
// through kv_token_offset, which holds the page-table load.
struct KvOperand {
  const int8_t* k;
  const int8_t* v;
  int skv;      // tokens per row of the buffer (ring capacity; paged:
                // n_pages * page)
  int d;        // head dim
  int kv_rep;   // q heads sharing one kv head (GQA)
  int hq;       // q heads per batch row (4D and paged layouts)
  int g;        // kv heads (4D and paged layouts)
  int kv_4d;
  const int* page_table = nullptr;  // (B, n_pages) int32; null: a ring
  int n_pages = 0;                  // logical pages per sequence
  int page = 0;                     // tokens per page (== the KV tile)
};

// Byte offset of token t's D-vector for kernel row r (r = batch*hq + head).
// Paged: logical token t of sequence b lives in physical page
// page_table[b, t / page] at slot t % page. The kernels only ask for
// t < skv, so the load never leaves the row's table.
__device__ __forceinline__ long long kv_token_offset(const KvOperand& kv,
                                                     int r, int t) {
  if (kv.page_table != nullptr) {
    const int b = r / kv.hq;
    const int head = (r % kv.hq) / kv.kv_rep;
    const long long phys = kv.page_table[b * kv.n_pages + t / kv.page];
    return ((phys * kv.page + t % kv.page) * kv.g + head) * kv.d;
  }
  if (kv.kv_4d) {
    const int b = r / kv.hq;
    const int head = (r % kv.hq) / kv.kv_rep;
    return ((static_cast<long long>(b) * kv.skv + t) * kv.g + head) * kv.d;
  }
  return (static_cast<long long>(r / kv.kv_rep) * kv.skv + t) * kv.d;
}

// Exact 2^-n for 0 <= n <= 126.
__device__ __forceinline__ float pow2_neg(int n) {
  return __int_as_float((127 - n) << 23);
}

// int32 Q·K dot -> round(acc · lmult) clipped to the int8 logit grid.
__device__ __forceinline__ int requant_logit(int acc, float lmult) {
  const float y = rintf(__fmul_rn(__int2float_rn(acc), lmult));
  return static_cast<int>(fminf(fmaxf(y, -128.f), 127.f));
}

// DA: the correction shift of values accumulated under the old max.
__device__ __forceinline__ int da_delta(int new_max, int old_max) {
  return min((new_max - old_max) >> kSoftmaxShift, 31);  // new_max >= old_max
}

// DA: shift k of one element; masked lanes take kMaskK before any shift
// of a possibly negative difference happens.
__device__ __forceinline__ int da_shift(int new_max, int logit, bool valid) {
  if (!valid) return kMaskK;
  return min((new_max - logit) >> kSoftmaxShift, 31);    // >= 0 when valid
}

// DI, adaptive: sigma_inv ~= 2^(e_r+8) / sigma in (128, 256].
__device__ __forceinline__ void adaptive_inverse(int sigma, int* inv,
                                                 int* e_r) {
  sigma = max(sigma, 1);
  const int e = 31 - __clz(sigma);
  const int pre = max(e + 8 - 30, 0);
  const int q = (1 << min(e + 8 - pre, 30)) / (sigma >> pre);
  *inv = min(max(q, 0), kSigmaInvMax);
  *e_r = e;
}

// DI, paper: 2^16 // sigma with e_r pinned to 8.
__device__ __forceinline__ void paper_inverse(int sigma, int* inv, int* e_r) {
  *inv = kPaperInvMax / max(sigma, 1);
  *e_r = 8;
}

// Output multiplier in the order of kernel.py:127-129:
// ((2 · inv) · 2^-(e_r+8)) · omult.
__device__ __forceinline__ float out_scale(int inv, int e_r, float omult) {
  float s = __fmul_rn(2.0f, __int2float_rn(inv));
  s = __fmul_rn(s, pow2_neg(e_r + 8));
  return __fmul_rn(s, omult);
}

__device__ __forceinline__ int8_t requant_out(float acc, float scale) {
  const float y = rintf(__fmul_rn(acc, scale));
  return static_cast<int8_t>(fminf(fmaxf(y, -128.f), 127.f));
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// The tensor-core block of the onepass and decode kernels
// ---------------------------------------------------------------------------

constexpr int kMaxTile = 256;        // keys per KV tile
constexpr int kMaxStages = 4;        // K/V stages of a streaming block
constexpr int kMaxCluster = 8;       // CTAs of a cluster (portable size)
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kInvalid = -1000;      // a masked logit (below kNegSentinel)

// Shared memory of one block: `stages` K and V staging tiles and the Q
// tile (rows of d + 16 bytes: 16-byte ldmatrix rows hit distinct banks,
// and the zeroed pad of a Q row is the upper half of the last k32 step
// when d is 16 mod 32), the u tile (rows of sp + 16 bytes; sp: the
// tile's keys rounded up to the 32 of an mma step), the row groups'
// partial maxima and sums, and the block's KV tile range. A block of a
// cluster (cluster > 1; `stages` is then its run of tiles) adds its
// rows' run maxima and their kernel rows (r, i, live, omult) and, for
// each tile of the kv row (stages · cluster at
// most), every row's δ and Σu and the int32 u·V of the output items the
// block folds (its share of the rows · d / 4 four-column items).
struct Layout {
  int ks, sp, us, stage, kv, q, u, red, range, rmax, rtab, dt, ut, pv, bytes;
};

__host__ __device__ inline Layout layout(int d, int bkv, int stages,
                                         int rows, int wn, int cluster) {
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
  l.rmax = l.range + 16;
  l.rtab = l.rmax;
  l.dt = l.rmax;
  l.ut = l.rmax;
  l.pv = l.rmax;
  l.bytes = l.rmax;
  if (cluster > 1) {
    const int tiles = stages * cluster;         // the row's tiles, at most
    const int share = (rows * d / 4 + cluster - 1) / cluster;
    l.rtab = l.rmax + rows * 4;
    l.dt = l.rtab + rows * 16;
    l.ut = l.dt + tiles * rows * 4;
    l.pv = l.ut + tiles * rows * 4;
    l.bytes = l.pv + tiles * share * 16;
  }
  return l;
}

// The (row groups, warps per group) pairs the kernels are built for: 16
// rows and 8 warps (4 at d <= 64: a warp takes >= 16 columns), 32 and 4,
// 64 and 2 for tiles of up to 128 keys; 32 and 4 for tiles over 128.
__host__ __device__ inline bool block_shape_ok(int wm, int wn, int d,
                                               int bkv) {
  if (bkv > 128) return wm == 2 && wn == 4;
  if (wm == 1) return wn == (d <= 64 ? 4 : 8);
  return (wm == 2 && wn == 4) || (wm == 4 && wn == 2);
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

// Wait until at most `n` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The WN warps of row group `id - 1` meet.
template <int WN>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * WN) : "memory");
}

// Every thread of every block of the cluster meets; what each wrote to
// its shared memory before is visible to the others after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The generic address of `p` (in this block's shared memory) in block
// `rank` of the cluster: plain loads and stores through it reach that
// block's shared memory.
template <typename T>
__device__ __forceinline__ T* cluster_ptr(T* p, unsigned rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out) : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// Four 8 x 16-byte matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and gets, of each matrix, bytes 4t..4t+3 of row g. The
// address is a pointer into shared memory or its smem_addr.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  ldsm4(r, smem_addr(p));
}

// The same, transposed as 16-bit pairs: of each matrix, bytes 2g, 2g+1
// of rows 2t and 2t+1.
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  ldsm4_t(r, smem_addr(p));
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

// requant_logit, clamped before it rounds (rint and the clamp to
// [-128, 127] commute), which keeps the rounding operand within 2^22.
__device__ __forceinline__ int requant_logit_fast(int acc, float lmult) {
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

// The keys [lo, hi) of tile j (offsets in the tile) the row sees:
// visible() as an interval.
__device__ __forceinline__ void row_keys(const Row& w, int j, int bkv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  const int base = j * bkv;
  int h = w.live() ? min(w.kv_len - base, bkv) : 0;
  if (causal || window > 0) h = min(h, w.qi + 1 - base);
  *hi = h;
  *lo = window > 0 ? w.qi - window + 1 - base : 0;
}

// What a block computes: q (BH, sq, D) int8; lmult/omult (BH,) f32; meta
// (BH, 3) int32 [kv_len, q_offset, q_len]; out (BH, sq, D) int8; the
// block geometry (n_mt blocks of packed rows per kv row, K/V stages,
// CTAs per cluster).
struct AttendArgs {
  const int8_t* q;
  KvOperand kv;
  const float* lmult;
  const float* omult;
  const int* meta;
  int8_t* out;
  int sq, bkv, causal, window, adaptive, n_mt, stages, cluster;
};

// One block: kv row kr (q rows kr·kv_rep + h) and a tile of kRows packed
// rows, query-major (packed row m is query m / kv_rep of head
// m % kv_rep), the tiles of the latest queries (the most KV tiles)
// first. Warp (wm, wn): packed rows 16·wm .. +16; keys wn·SMAX/WN .. of
// a tile in Q·Kᵀ and DA, head-dim columns wn·DMAX/WN .. in u·V. DMAX
// bounds the head dim, SMAX the KV tile. The block walks the union of
// its rows' KV tile ranges, in order; a tile outside a row's range is an
// exact no-op of DA for that row (δ 0, u 0, correction 1.0).
//
// CLUSTER false (cluster 1): the block streams the tiles through a ring
// of `stages` K/V stages (tile j + stages - 1 loads while tile j
// computes; with one stage, the next tile loads after the tile) and
// folds each tile into its running max, Σ and f32 accumulator as it
// goes.
//
// CLUSTER true (cluster 2-8): the cluster's CTAs (consecutive blocks)
// split the range into contiguous runs of at most `stages` tiles, all
// loaded at once. Each CTA takes its rows' maxima over its run; after a
// cluster barrier it reads the maxima of the runs before its own (the
// running max entering a tile is the prefix max of the tile maxima, from
// kNegSentinel), then computes each tile's δ, Σu and int32 u·V exactly
// as the streaming block does, and stores them into the shared memory of
// the CTAs that fold them: every CTA folds a share of the (row,
// 4-column) output items. After a second barrier each CTA folds its
// items over the tiles in order, Σ = (Σ >> δ) + 2·Σu and
// acc = acc·2^-δ + u·V, the streaming block's operations in its order,
// so every bit is the same. A kv row with at most one live tile skips
// the exchange: the cluster's first CTA streams it alone.
template <int DMAX, int SMAX, int WM, int WN, bool CLUSTER>
__device__ __forceinline__ void attend_block(const AttendArgs& p) {
  constexpr int kRows = 16 * WM;            // packed rows per block
  constexpr int kBlockThreads = 32 * WM * WN;
  constexpr int NTW = SMAX / WN / 8;        // n8 key tiles of a warp
  constexpr int NG = DMAX / WN / 16;        // 16-column head-dim groups
  static_assert(NTW % 2 == 0 && NG >= 1, "warp tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  // the arguments as locals: the lambdas below read them, not the
  // kernel's parameter space through a reference
  const KvOperand kv = p.kv;
  const int8_t* const q = p.q;
  const int* const meta = p.meta;
  const float* const lmult = p.lmult;
  const float* const omult = p.omult;
  int8_t* const out = p.out;
  const int d = kv.d, bkv = p.bkv, sq = p.sq, stages = p.stages;
  const int causal = p.causal, window = p.window, adaptive = p.adaptive;
  const int n_mt = p.n_mt, cluster = CLUSTER ? p.cluster : 1;
  const Layout L = layout(d, bkv, stages, kRows, WN, cluster);
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + L.q);
  int8_t* s_u = reinterpret_cast<int8_t*>(smem + L.u);
  int* s_max = reinterpret_cast<int*>(smem + L.red);
  int* s_sum = s_max + WN * kRows;
  int* s_range = reinterpret_cast<int*>(smem + L.range);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int cta = CLUSTER ? static_cast<int>(cluster_rank()) : 0;
  const int blk = blockIdx.x / cluster;
  const int n_kr = gridDim.x / cluster / n_mt;
  const int kr = blk % n_kr;
  const int m0 = (n_mt - 1 - blk / n_kr) * kRows;
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
  auto stage_k = [&](int stage) {
    return reinterpret_cast<int8_t*>(smem + L.kv + stage * L.stage);
  };
  auto load_tile = [&](int j, int stage) {
    int8_t* s_k = stage_k(stage);
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
  // Q's) goes out before the range is known. In a cluster tile 0 is the
  // first CTA's, and with runs of one tile, tile c is CTA c's.
  int early = -1;               // the tile loaded early, if any
  if (window == 0) early = CLUSTER && stages == 1 ? cta : cta == 0 ? 0 : -1;
  if (window == 0) {
    load_q();
    if (early >= 0) load_tile(early, 0);
    cp_async_commit();
  }

  // The block's KV tile range: the union of its rows' ranges.
  if (tid == 0) {
    s_range[0] = 1 << 30;
    s_range[1] = 0;
  }
  __syncthreads();
  if (tid < kRows) {
    const Row w = packed_row(kr, m0 + tid, sq, kv.kv_rep, meta, lmult,
                             omult);
    int b, e;
    row_range(w, kv.skv, bkv, causal, window, &b, &e);
    if (b < e) {
      atomicMin(&s_range[0], b);
      atomicMax(&s_range[1], e);
    }
    if constexpr (CLUSTER)      // what the fold needs of the row
      reinterpret_cast<int4*>(smem + L.rtab)[tid] =
          make_int4(w.r, w.i, w.live(), __float_as_int(w.om));
  }
  __syncthreads();
  const int j_begin = s_range[0], j_end = s_range[1];

  // This thread's two packed rows: g and g + 8 of its row group.
  const int row0 = 16 * wm + g;
  Row rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rows[h] = packed_row(kr, m0 + row0 + 8 * h, sq, kv.kv_rep, meta,
                         lmult, omult);
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

  // S = Q·Kᵀ of tile j for the group's 16 rows and the warp's keys,
  // requantized and masked (kInvalid), and this thread's partial row
  // maxima folded into mx.
  auto qk_tile = [&](const int8_t* s_k, int j, int (&s)[NTW][4],
                     int (&mx)[2]) {
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
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_keys(rows[h], j, bkv, causal, window, &lo[h], &hi[h]);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = (wn * NTW + nt) * 8 + 2 * t + e % 2;
        const bool ok = col >= lo[h] && col < hi[h];
        s[nt][e] = ok ? requant_logit_fast(s[nt][e], rows[h].lm) : kInvalid;
        mx[h] = max(mx[h], s[nt][e]);
      }
  };

  // One DA step of a tile on the group's rows, from its logits s and
  // this thread's partial maxima mx (qk_tile): from the running max m_run
  // (updated), δ and the tile's Σu per row, u into the u tile, and this
  // warp's columns of the int32 u·V.
  auto da_tile = [&](const int8_t* s_k, int (&s)[NTW][4], int (&mx)[2],
                     int (&m_run)[2], int (&delta)[2], int (&total)[2],
                     int (&pv)[NG][2][4]) {
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
      int part = kNegSentinel;
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
        s[nt][e] = 128 >> da_shift(new_max[h], x, x != kInvalid);
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      total[h] = 0;
#pragma unroll
      for (int w = 0; w < WN; ++w) total[h] += s_sum[w * kRows + row0 + 8 * h];
      delta[h] = da_delta(new_max[h], m_run[h]);
      m_run[h] = new_max[h];
    }
    // u·V over the tile's keys for the warp's head-dim columns: per 16
    // columns d0.., ldmatrix.trans gives lane (g, t) bytes 2g, 2g+1 of
    // keys 2t, 2t+1 (and 8+2t, 9+2t); __byte_perm splits them into the
    // B operands of columns d0 + 2g (tile 0) and d0 + 2g + 1 (tile 1).
    const int8_t* s_v = s_k + L.sp * L.ks;
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
  };

  // DI once per row, folded into the output requant: out[r, i, c..c+3].
  auto out_scale_of = [&](const Row& w, int sigma) {
    int inv, e_r;
    if (adaptive)
      adaptive_inverse(sigma, &inv, &e_r);
    else
      paper_inverse(sigma, &inv, &e_r);
    return out_scale(inv, e_r, w.om);
  };
  auto write_out = [&](const Row& w, float scale, int c, float a0, float a1,
                       float a2, float a3) {
    char4 v;
    v.x = requant_out(a0, scale);
    v.y = requant_out(a1, scale);
    v.z = requant_out(a2, scale);
    v.w = requant_out(a3, scale);
    *reinterpret_cast<char4*>(
        out + (static_cast<long long>(w.r) * sq + w.i) * d + c) = v;
  };

  // A kv row with at most one live tile needs no exchange: the first CTA
  // of its cluster runs it as a streaming block and the others leave.
  if (!CLUSTER || j_end - j_begin <= 1) {
    if (cta != 0) {
      cp_async_wait_all();      // the tile it loaded early
      return;
    }
    if (window > 0 && j_begin < j_end) {
      load_q();
      load_tile(j_begin, 0);
      cp_async_commit();
    }
    // the deeper stages of the ring, one copy group a tile
    int issued = min(j_end, j_begin + max(stages - 1, 1));
    for (int j = j_begin + 1; j < issued; ++j) {
      load_tile(j, j - j_begin);
      cp_async_commit();
    }

    float acc[NG][2][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][h][e] = 0.f;
    int m_run[2] = {kNegSentinel, kNegSentinel};
    int sigma[2] = {0, 0};

    int stage = 0, fill = issued - j_begin;
    for (int j = j_begin; j < j_end; ++j) {
      cp_async_wait_pending(issued - 1 - j);
      __syncthreads();          // tile j landed; every warp is done with j-1
      if (stages >= 2 && issued < j_end) {
        if (fill == stages) fill = 0;
        load_tile(issued, fill);  // in flight
        cp_async_commit();
        ++issued;
        ++fill;
      }
      if (group_live) {
        int s[NTW][4], mx[2] = {kNegSentinel, kNegSentinel};
        int delta[2], total[2], pv[NG][2][4];
        qk_tile(stage_k(stage), j, s, mx);
        da_tile(stage_k(stage), s, mx, m_run, delta, total, pv);
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sigma[h] = (sigma[h] >> delta[h]) + 2 * total[h];
          corr[h] = pow2_neg(delta[h]);
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
        __syncthreads();        // every warp is done with the one stage
        load_tile(j + 1, 0);
        cp_async_commit();
        issued = j + 2;
      }
      if (++stage == stages) stage = 0;
    }
    cp_async_wait_all();        // a speculative load of an empty range

    // Rows without a visible key (past q_len, or an empty range) output
    // 0. Lane (g, t) holds columns d0 + 4t .. d0 + 4t + 3 of each
    // 16-column group.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h].r < 0) continue;
      const float scale = out_scale_of(rows[h], sigma[h]);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int d0 = (wn * NG + n) * 16;
        if (d0 < d)
          write_out(rows[h], scale, d0 + 4 * t, acc[n][0][2 * h],
                    acc[n][1][2 * h], acc[n][0][2 * h + 1],
                    acc[n][1][2 * h + 1]);
      }
    }
  } else if constexpr (CLUSTER) {
    // ---- a cluster: this CTA's run [run_a, run_b), all tiles resident
    const int n_tiles = max(j_end - j_begin, 0);
    const int per = (n_tiles + cluster - 1) / cluster;
    const int run_a = j_begin + cta * per;
    const int run_b = min(j_end, run_a + per);
    int* s_rmax = reinterpret_cast<int*>(smem + L.rmax);
    int* s_dt = reinterpret_cast<int*>(smem + L.dt);
    int* s_ut = reinterpret_cast<int*>(smem + L.ut);
    int4* s_fold = reinterpret_cast<int4*>(smem + L.pv);
    if (window > 0) load_q();
    for (int j = run_a; j < run_b; ++j)
      if (j != early) load_tile(j, j - run_a);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // The rows' maxima over the run; the first tile's logits stay in
    // registers for the DA step.
    int s0[NTW][4], mx0[2] = {kNegSentinel, kNegSentinel};
    {
      int mx[2] = {kNegSentinel, kNegSentinel};
      if (group_live && run_a < run_b) {
        qk_tile(stage_k(0), run_a, s0, mx0);
        for (int j = run_a + 1; j < run_b; ++j) {
          int s[NTW][4];
          qk_tile(stage_k(j - run_a), j, s, mx);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = max(mx[h], mx0[h]);
        mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (t == 0) s_max[wn * kRows + row0 + 8 * h] = mx[h];
      }
      __syncthreads();
      if (tid < kRows) {
        int part = kNegSentinel;
        for (int w = 0; w < WN; ++w) part = max(part, s_max[w * kRows + tid]);
        s_rmax[tid] = part;
      }
    }
    cluster_sync();

    // Output (row, 4-column) item it belongs to CTA it / share, which
    // folds it; tile j_begin + x of every CTA lands in the owner's x-th
    // fold slot.
    const int quads = d / 4;
    const int share = (kRows * quads + cluster - 1) / cluster;
    // the running max entering the run: the maxima of the runs before it
    // (unrolled, so that the remote loads are in flight together)
    int m_run[2] = {kNegSentinel, kNegSentinel};
#pragma unroll
    for (int c = 0; c < kMaxCluster - 1; ++c)
      if (c < cta)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          m_run[h] = max(m_run[h], *cluster_ptr(s_rmax + row0 + 8 * h, c));
    if (group_live) {
      for (int j = run_a; j < run_b; ++j) {
        const int x = j - j_begin;
        group_sync<WN>(1 + wm);   // the group is done with the last u tile
        int s[NTW][4], mx[2] = {kNegSentinel, kNegSentinel};
        int delta[2], total[2], pv[NG][2][4];
        if (j == run_a) {
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = s0[nt][e];
          mx[0] = mx0[0];
          mx[1] = mx0[1];
        } else {
          qk_tile(stage_k(j - run_a), j, s, mx);
        }
        da_tile(stage_k(j - run_a), s, mx, m_run, delta, total, pv);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (wn == 0 && t == 0)
            for (int c = 0; c < cluster; ++c) {
              *cluster_ptr(s_dt + x * kRows + m, c) = delta[h];
              *cluster_ptr(s_ut + x * kRows + m, c) = total[h];
            }
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int d0 = (wn * NG + n) * 16;
            if (d0 < d) {
              const int it = m * quads + (d0 + 4 * t) / 4;
              const int owner = it / share;
              *cluster_ptr(s_fold + x * share + it - owner * share, owner) =
                  make_int4(pv[n][0][2 * h], pv[n][1][2 * h],
                            pv[n][0][2 * h + 1], pv[n][1][2 * h + 1]);
            }
          }
        }
      }
    }
    cluster_sync();             // every tile's δ, Σu and u·V have landed

    // The fold, in tile order, of this CTA's items.
    const int first = cta * share;
    const int last = min(kRows * quads, first + share);
    const int4* s_rtab = reinterpret_cast<const int4*>(smem + L.rtab);
    for (int it = first + tid; it < last; it += kBlockThreads) {
      const int m = it / quads, c = (it % quads) * 4;
      const int4 row = s_rtab[m];
      if (row.x < 0) continue;
      Row w{row.x, row.y, 0, 0, 0, 0.f, __int_as_float(row.w)};
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int sigma = 0;
      if (row.z) {
        for (int x = 0; x < n_tiles; ++x) {
          const int delta = s_dt[x * kRows + m];
          const int4 pv = s_fold[x * share + it - first];
          sigma = (sigma >> delta) + 2 * s_ut[x * kRows + m];
          const float corr = pow2_neg(delta);
          a0 = __fadd_rn(__fmul_rn(a0, corr), exact_float(pv.x));
          a1 = __fadd_rn(__fmul_rn(a1, corr), exact_float(pv.y));
          a2 = __fadd_rn(__fmul_rn(a2, corr), exact_float(pv.z));
          a3 = __fadd_rn(__fmul_rn(a3, corr), exact_float(pv.w));
        }
      }
      write_out(w, out_scale_of(w, sigma), c, a0, a1, a2, a3);
    }
  }
}

}  // namespace ita
