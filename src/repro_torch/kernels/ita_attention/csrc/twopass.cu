// ITA twopass attention for Hopper: replaces the two Pallas kernels behind
// `ita_attention_twopass` (src/repro/kernels/ita_attention/kernel.py:
// 133-182, 318-385), the paper's own dataflow (§III):
//
// - pass 1 (B5a), `qk_da_kernel`: int8 Q·Kᵀ -> int32 -> requant onto the
//   int8 logit grid; the attention matrix A is written to device memory
//   once, at every position (masked and padded ones too, as the TPU
//   kernel writes it); the streaming DA keeps the row max and Σ. On the
//   TPU the DI runs between the passes; here one block owns a row's whole
//   KV loop, so Σ is final at its end and the DI folds into pass 1's
//   epilogue, which writes (row max, Σ_inv, e_r).
// - pass 2 (B5b), `av_en_kernel`: re-reads A, EN `p = Σ_inv >> k`, p·V,
//   and `round((f32(acc) · 2^-e_r) · omult)` to int8 (no factor 2, no +8:
//   the paper's p = 256 >> k unit, not onepass's u = 128 >> k).
//
// What bounds them. Pass 1 writes A (Sq·Skv bytes per q row) and pass 2
// reads its visible part back: at prefill shapes the bytes of A over the
// memory rate, with the products (7.5 GOP of Q·Kᵀ at qwen2-7b's 4×512
// prefill) well under the tensor cores' time for them. What the card
// spends beside the bytes is the scalar work per logit: the requant (six
// float and integer instructions) and the DA step in pass 1, the EN
// shifts in pass 2.
//
// The first port ran one 128-thread block per (q row, 16 queries): each
// of the kv_rep q heads staged the same K/V tiles again, Q·Kᵀ ran on
// __dp4a, p·V on an int32 loop from shared memory, A went out one byte a
// thread and was read back one byte a thread, and the mask was tested per
// element. This design:
//
// - Packing. A block serves one kv row and a tile of 64 or 128 packed
//   (query, head) rows, query-major (packed row m is query m / kv_rep of
//   head m % kv_rep, as attend_block packs them): the 7 q heads of a kv
//   head share every staged K and V tile. One warp owns 16 packed rows
//   and all keys of a tile, so a row's max and Σ reduce inside a quad of
//   lanes. `kernel.twopass_geometry` picks the rows from the SM count and
//   the stages from the shared memory; the launchers check them.
// - Copies. K (pass 1), V and the A rows (pass 2) land by cp.async in a
//   ring of 2-4 stages: tile j + stages - 1 loads while tile j computes.
//   Pass 2 reads A only for tiles in its block's range, the union of its
//   rows' ranges (p is 0 elsewhere, whatever A holds); without a window
//   its first tiles go out before the ranges are known.
// - Pass 1 products on mma.sync m16n8k32 s8·s8 -> s32, Q's fragments in
//   registers for the whole KV loop; at head dim and KV tile 128 (the
//   prefill's shape) on wgmma m64n128k32 from the staged Q and K tiles
//   instead, a warpgroup's 64 rows a product (the faster of the two
//   there on an H100, PERF.md §6). The
//   accumulator columns are mapped to keys so that lane (g, t) ends up
//   holding keys 64G + 16t .. +15 of its rows g and g + 8 for each
//   64-key group G: the requantized tile leaves as 16-byte stores
//   straight from registers, four lanes on 64 contiguous bytes of an A
//   row. The ldmatrix row addresses (mma.sync) or the staged K rows'
//   order (wgmma, wg_row) carry the mapping; mma.sync's staged K rows
//   are 128-byte multiples with their 16-byte chunks XOR-swizzled
//   (k_swizzle), so the 8 keys an ldmatrix reads sit on 8 distinct bank
//   groups.
// - Pass 1 requant on the accumulator fragment with the exact conversions
//   of ita_common.cuh, kept as the float bits of (1.5·2^23 + logit)
//   (requant_biased): byte 0 is the int8 logit, and differences of two
//   such words are differences of logits, so the DA runs on them without
//   another conversion. The DA runs in tile order, only on tiles in a
//   row's range (an exact no-op elsewhere), on the interval of row_keys,
//   without a mask test where every row of the warp sees the whole tile.
// - Pass 2 products on mma.sync m16n8k32 u8·s8, p·V. The A operand comes
//   by ldmatrix from the staged A rows (rows of keys + 16 bytes,
//   conflict-free). The B operands (V, keys x columns) are built once a
//   tile for all warps: ldmatrix.trans of the staged V rows (swizzled by
//   v_swizzle; row addresses {0,1,4,5,..} and {2,3,6,7,..} give keys in
//   natural order) and two byte permutes per register, stored in
//   fragment order, so each warp reads its B operands with 16-byte
//   loads.
// - Pass 2 EN on the A words, four logits at once: with Σ_inv <= 255 a
//   row's p = Σ_inv >> k for k = 0..7 is a table of 8 bytes, k = (m - x)
//   >> 5 of the four logits is computed byte-wise in one 32-bit word
//   (no byte carries into the next: every k is 0..7 where the logit is
//   visible), and one prmt looks the four p up (en_table). Masked keys
//   go through a byte mask. p = Σ_inv >> k reaches 256 (SIGMA_INV_MAX:
//   query 0 of a causal call sees one key, Σ = 256, Σ_inv = 256 under
//   both DIs, k = 0), which does not fit u8: a warp with a row of Σ_inv
//   >= 256 takes EN a byte at a time and splits p into min(p, 255) +
//   (p >> 8), both u8 and both products added into the same int32
//   accumulator, the second only in k steps where a warp vote finds a p
//   of 256 (en_split; it needs Σ_inv <= 511 where a key is visible).
// - p·V accumulates in int32 (exact: |acc| <= 2^(e_r+7)); the TPU kernel
//   accumulates in f32, which equals it while |acc| < 2^24. The finalize
//   keeps its order: __fmul_rn(f32(acc), 2^-e_r), then requant_out.
//
// Pass 1's Σ shifts depend on the tile schedule, so one block keeps each
// row's KV loop in order. Pass 2 has no shift across tiles (its int32 sum
// is exact and associative) but keeps the same schedule. Rows past sq
// write nothing; rows without a visible key get row max kNegSentinel,
// Σ = 0 and an output of 0, with A still written.
#include "../../int8_matmul/csrc/wgmma.cuh"
#include "ita_common.cuh"

namespace {

using namespace ita;

// Bytes of a staged K or V row: the head dim rounded up to 128, so that
// XOR-swizzling its 16-byte chunks by up to 7 keeps them in the row and
// every row starts on bank 0.
__host__ __device__ inline int kv_row_bytes(int d) {
  return (d + 127) / 128 * 128;
}

// Keys of a staged tile: pass 1 rounds the tile up to its 64-key groups,
// pass 2 up to the 32 keys of an mma step.
__host__ __device__ inline int qk_keys(int bkv) { return (bkv + 63) / 64 * 64; }
__host__ __device__ inline int av_keys(int bkv) { return (bkv + 31) / 32 * 32; }

// Shared memory of a pass-1 block: `stages` K tiles, then the Q tile
// (rows of d + 16 bytes; the last 16 are zero, the upper half of the last
// k32 step when d is 16 mod 32).
__host__ __device__ inline int qk_smem(int d, int bkv, int rows, int stages) {
  return stages * qk_keys(bkv) * kv_row_bytes(d) + rows * (d + 16);
}

// Shared memory of a pass-2 block: `stages` of (V tile, A tile of rows of
// keys + 16 bytes), the tile's V in fragment order (keys x d bytes), then
// each row's A offset (8 bytes) and each warp's tile range (8 bytes).
__host__ __device__ inline int av_smem(int d, int bkv, int rows, int stages) {
  const int sp = av_keys(bkv);
  return stages * (sp * kv_row_bytes(d) + rows * (sp + 16)) + sp * d +
         rows * 8 + rows / 2;
}

// The chunk swizzles: chunk c of staged key tk sits at chunk c ^ swizzle.
// Pass 1's ldmatrix reads keys {0, 1, 16, 17, 32, 33, 48, 49} + base (bits
// 0, 4 and 5 differ), pass 2's ldmatrix.trans keys {0, 1, 4, 5, 8, 9, 12,
// 13} + base (bits 0, 2 and 3): each swizzle sends them to 8 distinct
// chunks of 16 bytes, and on lane l it comes to l % 8.
__device__ __forceinline__ int k_swizzle(int tk) {
  return (tk & 1) | ((tk >> 3) & 6);
}
__device__ __forceinline__ int v_swizzle(int tk) {
  return (tk & 1) | ((tk >> 1) & 6);
}

// requant_logit_fast as the float bits kMagicBits + logit.
__device__ __forceinline__ int requant_biased(int acc, float lmult) {
  const float y =
      fminf(fmaxf(__fmul_rn(exact_float(acc), lmult), -128.f), 127.f);
  return __float_as_int(__fadd_rn(y, kMagic));
}

// Byte 0 of each of x0..x3, in order.
__device__ __forceinline__ unsigned pack4(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                     0x5410);
}

// Byte b of w, sign-extended (prmt's sign-replicating selector).
template <int B>
__device__ __forceinline__ int sbyte(unsigned w) {
  int r;
  asm("prmt.b32 %0, %1, 0, %2;\n" : "=r"(r) : "r"(w), "n"(0x8880 + B * 0x1111));
  return r;
}

// x >> k for x >= 0 and any k >= 0 (PTX clamps shift amounts at 32).
__device__ __forceinline__ int shr_any(int x, int k) {
  int r;
  asm("shr.u32 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(k));
  return r;
}

// The wgmma path of pass 1 stages K key tk at row wg_row(tk) of the tile:
// B column n = 8j + c is then key 64(j / 8) + 16(c / 2) + 2(j % 8) + c % 2,
// the key order of the mma.sync path's fragments.
__device__ __forceinline__ int wg_row(int tk) {
  return 64 * (tk >> 6) + 8 * ((tk >> 1) & 7) + 2 * ((tk >> 4) & 3) +
         (tk & 1);
}

// Make this thread's shared-memory writes (cp.async, st.shared) visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One DA step of a warp's tile on rows g and g + 8 of its 16 (lane (g,
// t)): logits s as requant_biased words, n8 tile nt's element e at key
// 64(nt / 8) + 16t + 2(nt % 8) + e % 2; row h sees keys [lo, lo + span)
// (WHOLE: every key of the tile). Updates the running max and Σ.
template <int NT, bool WHOLE>
__device__ __forceinline__ void da_step(const int (&s)[NT][4], int nt_n,
                                        int t, const int (&lo)[2],
                                        const int (&span)[2],
                                        int (&m_run)[2], int (&sigma)[2]) {
  constexpr int kNeg = kNegSentinel + kMagicBits;
  auto seen = [&](int nt, int e) {
    const int key = 64 * (nt / 8) + 16 * t + 2 * (nt % 8) + e % 2;
    return WHOLE || static_cast<unsigned>(key - lo[e / 2]) <
                        static_cast<unsigned>(span[e / 2]);
  };
  // partial maxima and sums per n8 tile parity and element: four
  // independent chains a row
  int mx[2][4], us[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[h][c] = kNeg;
      us[h][c] = 0;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_n) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int& m = mx[e / 2][2 * (nt % 2) + e % 2];
      m = max(m, seen(nt, e) ? s[nt][e] : kNeg);
    }
  }
  int nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int x = max(max(mx[h][0], mx[h][1]), max(mx[h][2], mx[h][3]));
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 2));
    nm[h] = max(m_run[h], x);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_n) break;
    // a visible logit is at most nm: the shift is 0..7
#pragma unroll
    for (int e = 0; e < 4; ++e)
      us[e / 2][2 * (nt % 2) + e % 2] +=
          128 >> (seen(nt, e) ? (nm[e / 2] - s[nt][e]) >> kSoftmaxShift
                              : kMaskK);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int u = (us[h][0] + us[h][1]) + (us[h][2] + us[h][3]);
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    sigma[h] = (sigma[h] >> da_delta(nm[h], m_run[h])) + 2 * u;
    m_run[h] = nm[h];
  }
}

// Pass 1 (B5a). q (BH, sq, d) int8; k (BH / kv_rep, skv, d) int8; lmult
// (BH,) f32; meta (BH, 3) [kv_len, q_offset, q_len]. Writes a (BH, sq, skv)
// int8 and row_max / inv / e_r (BH, sq) int32. The block is kv row kr
// and packed rows m0 .. m0 + kRows (the tiles of the latest queries
// first); warp w holds packed rows 16w .. +16, lane (g, t) rows g and
// g + 8 of them. EXACT: d == DMAX and the staged tile is SMAX keys, so
// the loops over k steps and n8 tiles have no bound to test. The EXACT
// kernels of d = 128 and 128-key tiles (WG, the prefill's shape) take
// Q·Kᵀ on wgmma m64n128k32, a warpgroup's 64 rows a product, Q and K
// staged in its 128-byte swizzle; the others on mma.sync.
template <int DMAX, int SMAX, int WM, bool EXACT>
__global__ void __launch_bounds__(32 * WM, SMAX > 128 ? 1 : 2)
qk_da_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
             const float* __restrict__ lmult, const int* __restrict__ meta,
             int8_t* __restrict__ a, int* __restrict__ row_max,
             int* __restrict__ inv_out, int* __restrict__ er_out, int sq,
             int skv, int d, int bkv, int kv_rep, int causal, int window,
             int adaptive, int n_mt, int stages) {
  constexpr int kRows = 16 * WM, kBlockThreads = 32 * WM;
  constexpr int NT = SMAX / 8;                  // n8 key tiles, at most
  constexpr int kNeg = kNegSentinel + kMagicBits;
  constexpr bool WG = EXACT && DMAX == 128 && SMAX == 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_kr = gridDim.x / n_mt;
  const int kr = blockIdx.x % n_kr;
  const int m0 = (n_mt - 1 - blockIdx.x / n_kr) * kRows;
  const int rs = kv_row_bytes(d), sp = qk_keys(bkv), qs = WG ? d : d + 16;
  const int stage_bytes = sp * rs, n_kv = skv / bkv;
  const int nt_n = EXACT ? NT : sp / 8, dk = EXACT ? DMAX / 32 : (d + 31) / 32;
  const Div d16(d / 16), q16(WG ? d / 16 : d / 16 + 1);
  // wgmma's tiles start on 1024 bytes (within qk_smem: the Q tile's rows
  // are 16 bytes shorter)
  const unsigned raw = smem_addr(smem);
  const int pad = WG ? (1024 - static_cast<int>(raw % 1024)) % 1024 : 0;
  int8_t* s_k = reinterpret_cast<int8_t*>(smem + pad);
  int8_t* s_q = s_k + stages * stage_bytes;
  const unsigned s_base = raw + pad;
  const int8_t* k_row = k + static_cast<long long>(kr) * skv * d;

  // Q: packed row m is q[kr·kv_rep + m % kv_rep, m / kv_rep]; rows past
  // sq and the pad chunk are zero (WG: no pad chunk, chunks swizzled).
  // Its own copy group, then the ring's first stages - 1 tiles, one
  // group each.
  for (int idx = tid; idx < kRows * q16.n; idx += kBlockThreads) {
    const int mr = q16.quo(idx), c = q16.rem(idx);
    const int m = m0 + mr, i = m / kv_rep;
    int8_t* dst = s_q + mr * qs + ((WG ? c ^ (mr & 7) : c) << 4);
    if (c < d16.n && i < sq)
      cp_async16(dst, q + (static_cast<long long>(kr * kv_rep + m % kv_rep) *
                               sq + i) * d + c * 16);
    else
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  }
  cp_async_commit();
  auto load_tile = [&](int j, int stage) {
    int8_t* dst = s_k + stage * stage_bytes;
    const int8_t* src = k_row + static_cast<long long>(j) * bkv * d;
    for (int idx = tid; idx < bkv * d16.n; idx += kBlockThreads) {
      const int tk = d16.quo(idx), c = d16.rem(idx);
      if constexpr (WG) {
        const int n = wg_row(tk);
        cp_async16(dst + n * rs + ((c ^ (n & 7)) << 4), src + tk * d + c * 16);
      } else {
        cp_async16(dst + tk * rs + ((c ^ k_swizzle(tk)) << 4),
                   src + tk * d + c * 16);
      }
    }
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_kv) load_tile(s, s);
    cp_async_commit();
  }

  Row rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rows[h] = packed_row(kr, m0 + 16 * warp + g + 8 * h, sq, kv_rep, meta,
                         lmult, lmult);      // pass 1 has no omult
  const bool warp_rows = __any_sync(0xffffffffu, rows[0].r >= 0);

  // Q's A fragments, once: rows 16w + (l/8 % 2)·8 + l % 8, bytes
  // (l/16)·16 of each k32 step.
  cp_async_wait_pending(stages - 1);
  if (WG) fence_proxy_async();
  __syncthreads();
  unsigned qf[DMAX / 32][4];
  const unsigned q_lane =
      s_base + stages * stage_bytes +
      (16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7)) * qs + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < DMAX / 32; ++kk) {
    qf[kk][0] = qf[kk][1] = qf[kk][2] = qf[kk][3] = 0u;
    if (!WG && kk < dk) ldsm4(qf[kk], q_lane + kk * 32);
  }

  // K's ldmatrix rows: matrix l/8 of pair np is n8 tile 2np + l/16,
  // chunk 2kk + l/8 % 2; its row l % 8 = c is that tile's column c, key
  // 64(np/4) + 4(np%4) + 2(l/16) + 16(c/2) + c%2 (k_swizzle: c).
  const int c8 = lane & 7;
  const unsigned k_lane =
      s_base + (2 * (lane >> 4) + 16 * (c8 >> 1) + (c8 & 1)) * rs;
  const int k_hc = ((lane >> 3) & 1) ^ c8;
  const bool aligned = skv % 16 == 0 && bkv % 16 == 0;

  int m_run[2] = {kNeg, kNeg}, sigma[2] = {0, 0};
  int stage = 0;
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_pending(stages - 2);
    if (WG) fence_proxy_async();
    __syncthreads();          // tile j landed; every warp is done with j-1
    {
      int fill = stage + stages - 1;
      if (fill >= stages) fill -= stages;
      if (j + stages - 1 < n_kv) load_tile(j + stages - 1, fill);
      cp_async_commit();
    }
    int s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
    if constexpr (WG) {
      // every warp of a warpgroup joins its products
      int (&sf)[4 * NT] = *reinterpret_cast<int(*)[4 * NT]>(&s[0][0]);
      const unsigned qa = s_base + stages * stage_bytes + warp / 4 * 64 * qs;
      const unsigned kb = s_base + stage * stage_bytes;
      fence_acc(sf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 32; ++kk)
        wgmma_n128(sf, sw128_desc(qa + 32 * kk), sw128_desc(kb + 32 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sf);
    }
    if (warp_rows) {
      if constexpr (!WG) {
        const unsigned sk = k_lane + stage * stage_bytes;
#pragma unroll
        for (int kk = 0; kk < DMAX / 32; ++kk) {
          if (kk >= dk) break;
          const int chunk = ((2 * kk) ^ k_hc) << 4;
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            if (2 * np < nt_n) {
              unsigned b[4];
              ldsm4(b, sk + (64 * (np >> 2) + 4 * (np & 3)) * rs + chunk);
              mma_s8s8(s[2 * np], qf[kk], b[0], b[1]);
              mma_s8s8(s[2 * np + 1], qf[kk], b[2], b[3]);
            }
          }
        }
      }
      // Lane (g, t), n8 tile nt, element e: row g + 8(e / 2), key
      // 64(nt / 8) + 16t + 2(nt % 8) + e % 2. Per 64-key group G: the
      // requant, then 16 bytes per row to A, every position.
#pragma unroll
      for (int G = 0; G < SMAX / 64; ++G) {
        if (8 * G >= nt_n) break;
#pragma unroll
        for (int nt = 8 * G; nt < 8 * G + 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = requant_biased(s[nt][e], rows[e / 2].lm);
        const int key0 = 64 * G + 16 * t;
        if (key0 >= bkv) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rows[h].r < 0) continue;
          int8_t* dst = a + (static_cast<long long>(rows[h].r) * sq +
                             rows[h].i) * skv + j * bkv + key0;
          unsigned w[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int nt = 8 * G + 2 * x;
            w[x] = pack4(s[nt][2 * h], s[nt][2 * h + 1], s[nt + 1][2 * h],
                         s[nt + 1][2 * h + 1]);
          }
          if (aligned) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
          } else {
#pragma unroll
            for (int b = 0; b < 16; ++b)
              if (key0 + b < bkv)
                dst[b] = static_cast<int8_t>(w[b / 4] >> (8 * (b % 4)));
          }
        }
      }

      // DA on the keys [lo, lo + span) of each row, in tile order.
      int lo[2], span[2];
      bool seen = false, full = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int l, hi;
        row_keys(rows[h], j, bkv, causal, window, &l, &hi);
        lo[h] = max(l, 0);
        span[h] = max(hi - lo[h], 0);
        seen |= span[h] > 0;
        full &= rows[h].r < 0 || (l <= 0 && hi >= sp);
      }
      if (__any_sync(0xffffffffu, seen)) {
        if (__all_sync(0xffffffffu, full))
          da_step<NT, true>(s, nt_n, t, lo, span, m_run, sigma);
        else
          da_step<NT, false>(s, nt_n, t, lo, span, m_run, sigma);
      }
    }
    if (++stage == stages) stage = 0;
  }
  cp_async_wait_all();        // the ring's empty tail groups

  // DI once per row (Σ is final: this block ran the row's whole KV loop).
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h].r < 0) continue;
      int inv, e_r;
      if (adaptive)
        adaptive_inverse(sigma[h], &inv, &e_r);
      else
        paper_inverse(sigma[h], &inv, &e_r);
      const long long o = static_cast<long long>(rows[h].r) * sq + rows[h].i;
      row_max[o] = m_run[h] - kMagicBits;
      inv_out[o] = inv;
      er_out[o] = e_r;
    }
  }
}

// EN by table for a row with Σ_inv <= 255 and at least one visible key:
// its p = Σ_inv >> k for k = 0..7 as two words of bytes, and the row
// max's constants for en_table.
struct EnRow {
  unsigned t_lo, t_hi;   // p for k = 0..3 and 4..7
  unsigned c4, k4;       // (M % 32 + 32)·0x01010101, (M / 32 - 1)·0x01010101
};

__device__ __forceinline__ EnRow en_row(int m, int inv) {
  const int mu = m + 128;           // M: the row max as an unsigned byte
  return {pack4(inv, inv >> 1, inv >> 2, inv >> 3),
          pack4(inv >> 4, inv >> 5, inv >> 6, inv >> 7),
          static_cast<unsigned>((mu & 31) + 32) * 0x01010101u,
          static_cast<unsigned>((mu >> 5) - 1) * 0x01010101u};
}

// p of four logits of a row (a word of A), each at most the row max:
// with u = x + 128 and M = m + 128 as bytes, k = (M - u) >> 5 =
// M/32 - u/32 - (u%32 > M%32), computed a byte at a time in one word (every
// byte stays in 0..7, so no byte carries into the next), then
// p = table[k] by one prmt.
__device__ __forceinline__ unsigned en_table(unsigned w, const EnRow& e) {
  const unsigned ul = w & 0x1F1F1F1Fu;
  const unsigned uh = ((w >> 5) & 0x07070707u) ^ 0x04040404u;
  const unsigned c = ((e.c4 - ul) >> 5) & 0x01010101u;   // u%32 <= M%32
  const unsigned k = e.k4 + c - uh;
  const unsigned nib = k | (k >> 4);    // bytes 0 and 2: k0 | k1 << 4, ..
  return __byte_perm(e.t_lo, e.t_hi, __byte_perm(nib, 0, 0x0020));
}

// The bytes b of a word at keys key .. key + 3 with lo <= key + b < hi.
__device__ __forceinline__ unsigned byte_mask(int key, int lo, int hi) {
  const int nh = min(max(hi - key, 0), 4), nl = min(max(lo - key, 0), 4);
  return static_cast<unsigned>(shr_any(-1, 32 - 8 * nh)) &
         ~static_cast<unsigned>(shr_any(-1, 32 - 8 * nl));
}

// EN of one A fragment word, a byte at a time (4 logits of one row, keys
// key .. key + 3 of the tile): p = Σ_inv >> k, split into min(p, 255) in
// `pw` and p >> 8 in `ew`, both u8 for p <= 511.
__device__ __forceinline__ void en_split(unsigned w, int m, int inv, int key,
                                         int lo, int span, unsigned& pw,
                                         unsigned& ew) {
  const int x[4] = {sbyte<0>(w), sbyte<1>(w), sbyte<2>(w), sbyte<3>(w)};
  int p[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kb =
        static_cast<unsigned>(key + b - lo) < static_cast<unsigned>(span)
            ? max(m - x[b], 0) >> kSoftmaxShift
            : kMaskK;
    p[b] = shr_any(inv, kb);
  }
  pw = pack4(min(p[0], 255), min(p[1], 255), min(p[2], 255),
             min(p[3], 255));
  ew = pack4(p[0] >> 8, p[1] >> 8, p[2] >> 8, p[3] >> 8);
}

// How a warp's rows take EN in a tile: by table with every key visible,
// by table with a byte mask, or a byte at a time with p split (a row of
// Σ_inv >= 256 among them).
enum EnMode { kEnWhole, kEnMasked, kEnSplit };

// One tile of pass 2 for a warp's 16 rows: EN on the fly, acc += p·V.
// a_lane: this lane's ldmatrix row of the warp's A tile; vf: this lane's
// 16 bytes of item 0 of the tile's V fragments (item ks·ng + n: the B
// operands of k step ks and columns 16n .. +16).
template <int DMAX, bool EXACT, int MODE>
__device__ __forceinline__ void av_tile(unsigned a_lane, const uint4* vf,
                                        int nk, int d, int t,
                                        const EnRow (&er)[2],
                                        const int (&m)[2], const int (&inv)[2],
                                        const int (&lo)[2],
                                        const int (&span)[2],
                                        int (&acc)[DMAX / 16][2][4]) {
  constexpr int NG = DMAX / 16;
  const int ng = EXACT ? NG : d / 16;
#pragma unroll 1
  for (int ks = 0; ks < nk; ++ks) {
    unsigned af[4], pf[4], ef[4] = {0u, 0u, 0u, 0u};
    ldsm4(af, a_lane + ks * 32);
    // af[x]: row g + 8(x % 2), keys 32ks + 16(x / 2) + 4t .. +3
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int h = x % 2, key = 32 * ks + 16 * (x / 2) + 4 * t;
      if (MODE == kEnWhole) {
        pf[x] = en_table(af[x], er[h]);
      } else if (MODE == kEnMasked) {
        // masked bytes read as -128, in range of the table, then 0
        const unsigned mk = byte_mask(key, lo[h], lo[h] + span[h]);
        pf[x] = en_table((af[x] & mk) | (0x80808080u & ~mk), er[h]) & mk;
      } else {
        en_split(af[x], m[h], inv[h], key, lo[h], span[h], pf[x], ef[x]);
      }
    }
    const bool carry =
        MODE == kEnSplit &&
        __any_sync(0xffffffffu, (ef[0] | ef[1] | ef[2] | ef[3]) != 0u);
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      if (n >= ng) break;
      const uint4 b = vf[(ks * ng + n) * 32];
      mma_u8s8(acc[n][0], pf, b.x, b.y);
      mma_u8s8(acc[n][1], pf, b.z, b.w);
      if (carry) {
        mma_u8s8(acc[n][0], ef, b.x, b.y);
        mma_u8s8(acc[n][1], ef, b.z, b.w);
      }
    }
  }
}

// Pass 2 (B5b). a (BH, sq, skv) int8; row_max / inv / e_r (BH, sq) int32;
// v (BH / kv_rep, skv, d) int8; omult (BH,) f32; meta as pass 1. Writes
// out (BH, sq, d) int8. Block and warp rows as pass 1; the block walks
// the union of its rows' tile ranges. Pass 2 reads pass 1's statistics:
// row_max at least every visible logit of its row, Σ_inv <= 511 where a
// key is visible. EXACT: d == DMAX.
template <int DMAX, int WM, bool EXACT>
__global__ void __launch_bounds__(32 * WM, DMAX > 128 ? 1 : 2)
av_en_kernel(const int8_t* __restrict__ a, const int* __restrict__ row_max,
             const int* __restrict__ inv, const int* __restrict__ e_r,
             const int8_t* __restrict__ v, const float* __restrict__ omult,
             const int* __restrict__ meta, int8_t* __restrict__ out, int sq,
             int skv, int d, int bkv, int kv_rep, int causal, int window,
             int n_mt, int stages) {
  constexpr int kRows = 16 * WM, kBlockThreads = 32 * WM;
  constexpr int NG = DMAX / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_kr = gridDim.x / n_mt;
  const int kr = blockIdx.x % n_kr;
  const int m0 = (n_mt - 1 - blockIdx.x / n_kr) * kRows;
  const int rs = kv_row_bytes(d), sp = av_keys(bkv), as = sp + 16;
  const int a_tile = sp * rs, stage_bytes = a_tile + kRows * as;
  const int nk = sp / 32, ng = EXACT ? NG : d / 16;
  const Div d16(d / 16), a16((bkv + 15) / 16);
  const unsigned s_base = smem_addr(smem);
  uint4* s_vf = reinterpret_cast<uint4*>(smem + stages * stage_bytes);
  long long* s_off =
      reinterpret_cast<long long*>(smem + stages * stage_bytes + sp * d);
  int2* s_range = reinterpret_cast<int2*>(s_off + kRows);
  const int8_t* v_row = v + static_cast<long long>(kr) * skv * d;
  const bool aligned = skv % 16 == 0 && bkv % 16 == 0;

  // Each row's A offset (-1 past sq).
  if (tid < kRows) {
    const int m = m0 + tid, i = m / kv_rep;
    s_off[tid] = i < sq ? (static_cast<long long>(kr * kv_rep + m % kv_rep) *
                           sq + i) * skv : -1;
  }
  __syncthreads();

  // V and the A rows of tile j into a stage (A only for rows that exist).
  auto load_tile = [&](int j, int stage) {
    int8_t* s_v = reinterpret_cast<int8_t*>(smem + stage * stage_bytes);
    int8_t* s_a = s_v + a_tile;
    const int8_t* src = v_row + static_cast<long long>(j) * bkv * d;
    for (int idx = tid; idx < bkv * d16.n; idx += kBlockThreads) {
      const int tk = d16.quo(idx), c = d16.rem(idx);
      cp_async16(s_v + tk * rs + ((c ^ v_swizzle(tk)) << 4),
                 src + tk * d + c * 16);
    }
    for (int idx = tid; idx < kRows * a16.n; idx += kBlockThreads) {
      const int mr = a16.quo(idx), c = a16.rem(idx);
      const long long off = s_off[mr];
      if (off < 0) continue;
      const int8_t* src_a = a + off + j * bkv + c * 16;
      int8_t* dst = s_a + mr * as + c * 16;
      if (aligned) {
        cp_async16(dst, src_a);
      } else {
        for (int b = 0; b < 16 && c * 16 + b < bkv; ++b) dst[b] = src_a[b];
      }
    }
  };
  // Without a window every row's range starts at tile 0: the ring's
  // first tiles go out before the ranges are known.
  const bool early = window == 0;
  if (early)
    for (int s = 0; s < stages - 1; ++s) {
      if (s < skv / bkv) load_tile(s, s);
      cp_async_commit();
    }

  // This lane's rows: meta, statistics and e_r, all loads at once; the
  // block's tile range is the union of its warps' ranges.
  Row rows[2];
  int m[2], iv[2], ex[2];
  EnRow er[2];
  bool big = false;
  int2 range = make_int2(1 << 30, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = packed_row(kr, m0 + 16 * warp + g + 8 * h, sq, kv_rep, meta,
                         omult, omult);      // pass 2 has no lmult
    m[h] = iv[h] = ex[h] = 0;
    if (rows[h].r >= 0) {
      const long long o = static_cast<long long>(rows[h].r) * sq + rows[h].i;
      m[h] = row_max[o];
      iv[h] = inv[o];
      ex[h] = e_r[o];
    }
    big |= rows[h].live() && iv[h] >= 256;
    er[h] = en_row(m[h], iv[h]);
    int b, e;
    row_range(rows[h], skv, bkv, causal, window, &b, &e);
    if (b < e) range = make_int2(min(range.x, b), max(range.y, e));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    range.x = min(range.x, __shfl_xor_sync(0xffffffffu, range.x, o));
    range.y = max(range.y, __shfl_xor_sync(0xffffffffu, range.y, o));
  }
  if (lane == 0) s_range[warp] = range;
  const bool warp_rows = __any_sync(0xffffffffu, rows[0].r >= 0);
  big = __any_sync(0xffffffffu, big);
  __syncthreads();
  int j_begin = 1 << 30, j_end = 0;
#pragma unroll
  for (int w = 0; w < WM; ++w) {
    j_begin = min(j_begin, s_range[w].x);
    j_end = max(j_end, s_range[w].y);
  }
  if (!early)
    for (int s = 0; s < stages - 1; ++s) {
      if (j_begin + s < j_end) load_tile(j_begin + s, s);
      cp_async_commit();
    }

  // ldmatrix rows: A as pass 1's Q; V (ldmatrix.trans, into the
  // fragments) keys 16(l/16) + 4(c/2) + 2(l/8 % 2) + c%2 of a k32 step
  // for lane l, c = l % 8 (v_swizzle: c): lane (g, t) then holds keys
  // 4t .. 4t + 3 (and 16 + ..) of columns 16n + 2g and 16n + 2g + 1.
  const int c8 = lane & 7;
  const unsigned a_lane =
      s_base + a_tile +
      (16 * warp + ((lane >> 3) & 1) * 8 + c8) * as + (lane >> 4) * 16;
  const unsigned v_lane =
      s_base + (16 * (lane >> 4) + 4 * (c8 >> 1) + 2 * ((lane >> 3) & 1) +
                (c8 & 1)) * rs;
  const uint4* vf = s_vf + lane;

  int acc[NG][2][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x)
      acc[n][x][0] = acc[n][x][1] = acc[n][x][2] = acc[n][x][3] = 0;

  int stage = 0;
  for (int j = j_begin; j < j_end; ++j) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();          // tile j landed; every warp is done with j-1
    // V's B fragments, once a tile for every warp: item it = ks·ng + n
    for (int it = warp; it < nk * ng; it += WM) {
      const int ks = it / ng, n = it - ks * ng;
      unsigned r[4];
      ldsm4_t(r, v_lane + stage * stage_bytes + ks * 32 * rs +
                     ((n ^ c8) << 4));
      s_vf[it * 32 + lane] = make_uint4(
          __byte_perm(r[0], r[1], 0x6420), __byte_perm(r[2], r[3], 0x6420),
          __byte_perm(r[0], r[1], 0x7531), __byte_perm(r[2], r[3], 0x7531));
    }
    __syncthreads();
    {
      int fill = stage + stages - 1;
      if (fill >= stages) fill -= stages;
      if (j + stages - 1 < j_end) load_tile(j + stages - 1, fill);
      cp_async_commit();
    }
    if (warp_rows) {
      int lo[2], span[2];
      bool seen = false, full = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int l, hi;
        row_keys(rows[h], j, bkv, causal, window, &l, &hi);
        lo[h] = max(l, 0);
        span[h] = max(hi - lo[h], 0);
        seen |= span[h] > 0;
        full &= rows[h].r < 0 || (l <= 0 && hi >= sp);
      }
      if (__any_sync(0xffffffffu, seen)) {
        const unsigned al = a_lane + stage * stage_bytes;
        if (big)
          av_tile<DMAX, EXACT, kEnSplit>(al, vf, nk, d, t, er, m, iv, lo,
                                         span, acc);
        else if (__all_sync(0xffffffffu, full))
          av_tile<DMAX, EXACT, kEnWhole>(al, vf, nk, d, t, er, m, iv, lo,
                                         span, acc);
        else
          av_tile<DMAX, EXACT, kEnMasked>(al, vf, nk, d, t, er, m, iv, lo,
                                          span, acc);
      }
    }
    if (++stage == stages) stage = 0;
  }
  cp_async_wait_all();

  // round((f32(acc) · 2^-e_r) · omult), clipped to int8 (kernel.py:180).
  // Lane (g, t) holds columns 16n + 4t .. +3 of rows g and g + 8.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h].r < 0) continue;
    const long long o = static_cast<long long>(rows[h].r) * sq + rows[h].i;
    const float sc = pow2_neg(ex[h]);
    const float om = rows[h].om;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      if (n >= ng) break;
      char4 y;
      y.x = requant_out(__fmul_rn(__int2float_rn(acc[n][0][2 * h]), sc), om);
      y.y = requant_out(__fmul_rn(__int2float_rn(acc[n][1][2 * h]), sc), om);
      y.z = requant_out(__fmul_rn(__int2float_rn(acc[n][0][2 * h + 1]), sc),
                        om);
      y.w = requant_out(__fmul_rn(__int2float_rn(acc[n][1][2 * h + 1]), sc),
                        om);
      *reinterpret_cast<char4*>(out + o * d + 16 * n + 4 * t) = y;
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The geometry `kernel.twopass_geometry` gives a pass: 4 or 8 warps of 16
// packed rows (8 only at d and KV tiles up to 128), 2-4 stages, within a
// block's shared memory. Returns the shared memory, or -1.
int check(int bh, int skv, int d, int bkv, int kv_rep, int wm, int stages,
          int smem) {
  if (bkv <= 0 || bkv > kMaxTile || skv % bkv || d <= 0 || d % 16 ||
      d > kMaxHeadDim || kv_rep <= 0 || bh % kv_rep ||
      (wm != 4 && wm != 8) || (wm == 8 && (d > 128 || bkv > 128)) ||
      stages < 2 || stages > kMaxStages || smem > kMaxSmem)
    return -1;
  return smem;
}

template <int DMAX, int SMAX, int WM, bool EXACT>
int launch_qk(const void* q, const void* k, const void* lmult,
              const void* meta, void* a, void* row_max, void* inv, void* e_r,
              int blocks, int smem, int sq, int skv, int d, int bkv,
              int kv_rep, int causal, int window, int adaptive, int n_mt,
              int stages, cudaStream_t st) {
  auto* kernel = qk_da_kernel<DMAX, SMAX, WM, EXACT>;
  if (const int e = prepare(kernel, smem)) return e;
  if (blocks == 0) return 0;
  kernel<<<blocks, 32 * WM, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(lmult), static_cast<const int*>(meta),
      static_cast<int8_t*>(a), static_cast<int*>(row_max),
      static_cast<int*>(inv), static_cast<int*>(e_r), sq, skv, d, bkv,
      kv_rep, causal, window, adaptive, n_mt, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, int WM, bool EXACT>
int launch_av(const void* a, const void* row_max, const void* inv,
              const void* e_r, const void* v, const void* omult,
              const void* meta, void* out, int blocks, int smem, int sq,
              int skv, int d, int bkv, int kv_rep, int causal, int window,
              int n_mt, int stages, cudaStream_t st) {
  auto* kernel = av_en_kernel<DMAX, WM, EXACT>;
  if (const int e = prepare(kernel, smem)) return e;
  if (blocks == 0) return 0;
  kernel<<<blocks, 32 * WM, smem, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int*>(row_max),
      static_cast<const int*>(inv), static_cast<const int*>(e_r),
      static_cast<const int8_t*>(v), static_cast<const float*>(omult),
      static_cast<const int*>(meta), static_cast<int8_t*>(out), sq, skv, d,
      bkv, kv_rep, causal, window, n_mt, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1 (B5a). q (bh, sq, d), k (bh / kv_rep, skv, d) int8; lmult (bh,)
// f32; meta (bh, 3) int32. Outputs a (bh, sq, skv) int8, row_max / inv /
// e_r (bh, sq) int32. wm: warps of 16 packed rows a block; stages: K
// tiles in flight. Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_twopass_qk_launch(const void* q, const void* k,
                                     const void* lmult, const void* meta,
                                     void* a, void* row_max, void* inv,
                                     void* e_r, int bh, int sq, int skv,
                                     int d, int bkv, int kv_rep, int causal,
                                     int window, int adaptive, int wm,
                                     int stages, void* stream) {
  const int smem = check(bh, skv, d, bkv, kv_rep, wm, stages,
                         qk_smem(d, bkv, 16 * wm, stages));
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long packed = static_cast<long long>(sq) * kv_rep;
  const int n_mt = static_cast<int>((packed + 16 * wm - 1) / (16 * wm));
  const int blocks = bh / kv_rep * n_mt;
  auto st = static_cast<cudaStream_t>(stream);
  // The kernels for head dims up to 64, 128, 256 and tiles up to 128 or
  // 256 keys; EXACT where the call fills them.
#define ITA_QK(DM, SM, W)                                                    \
  (d == DM && qk_keys(bkv) == SM                                             \
       ? launch_qk<DM, SM, W, true>(q, k, lmult, meta, a, row_max, inv, e_r, \
                                    blocks, smem, sq, skv, d, bkv, kv_rep,   \
                                    causal, window, adaptive, n_mt, stages,  \
                                    st)                                      \
       : launch_qk<DM, SM, W, false>(q, k, lmult, meta, a, row_max, inv,     \
                                     e_r, blocks, smem, sq, skv, d, bkv,     \
                                     kv_rep, causal, window, adaptive, n_mt, \
                                     stages, st))
  if (d <= 64) {
    if (bkv > 128) return ITA_QK(64, 256, 4);
    return wm == 8 ? ITA_QK(64, 128, 8) : ITA_QK(64, 128, 4);
  }
  if (d <= 128) {
    if (bkv > 128) return ITA_QK(128, 256, 4);
    return wm == 8 ? ITA_QK(128, 128, 8) : ITA_QK(128, 128, 4);
  }
  return bkv > 128 ? ITA_QK(256, 256, 4) : ITA_QK(256, 128, 4);
#undef ITA_QK
}

// Pass 2 (B5b). a (bh, sq, skv) int8; row_max / inv / e_r (bh, sq) int32;
// v (bh / kv_rep, skv, d) int8; omult (bh,) f32; meta (bh, 3) int32.
// Output out (bh, sq, d) int8. wm, stages as pass 1.
extern "C" int ita_twopass_av_launch(const void* a, const void* row_max,
                                     const void* inv, const void* e_r,
                                     const void* v, const void* omult,
                                     const void* meta, void* out, int bh,
                                     int sq, int skv, int d, int bkv,
                                     int kv_rep, int causal, int window,
                                     int wm, int stages, void* stream) {
  const int smem = check(bh, skv, d, bkv, kv_rep, wm, stages,
                         av_smem(d, bkv, 16 * wm, stages));
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long packed = static_cast<long long>(sq) * kv_rep;
  const int n_mt = static_cast<int>((packed + 16 * wm - 1) / (16 * wm));
  const int blocks = bh / kv_rep * n_mt;
  auto st = static_cast<cudaStream_t>(stream);
#define ITA_AV(DM, W)                                                        \
  (d == DM ? launch_av<DM, W, true>(a, row_max, inv, e_r, v, omult, meta,    \
                                    out, blocks, smem, sq, skv, d, bkv,      \
                                    kv_rep, causal, window, n_mt, stages,    \
                                    st)                                      \
           : launch_av<DM, W, false>(a, row_max, inv, e_r, v, omult, meta,   \
                                     out, blocks, smem, sq, skv, d, bkv,     \
                                     kv_rep, causal, window, n_mt, stages,   \
                                     st))
  if (d <= 64) return wm == 8 ? ITA_AV(64, 8) : ITA_AV(64, 4);
  if (d <= 128) return wm == 8 ? ITA_AV(128, 8) : ITA_AV(128, 4);
  return ITA_AV(256, 4);
#undef ITA_AV
}
