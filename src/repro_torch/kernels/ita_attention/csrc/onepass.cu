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
// first port did its products on the scalar pipe (Q·Kᵀ by __dp4a, u·V
// by an int32 loop from shared memory), ran one block per (q row, 16
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
//   barrier of the group's warps. `kernel.onepass_geometry` picks (rows,
//   WN) and the stages for the call and the launcher checks them: 16
//   rows and 8 warps for a decode step (one live row group: all warps on
//   its keys), 64 rows and 2 warps when the call has blocks enough to
//   fill the card's SMs four times over (the SMs' instruction rate binds,
//   and a K/V tile is shared by the most rows), else 32 rows and 4 warps
//   (twice the blocks, shorter chains).
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
// The block is ita_common.cuh's `attend_block` (the decode kernel runs
// the same block with deeper stages or in a cluster), streaming its
// tiles (cluster 1).
//
// KV is never split across blocks (the integer Σ shifts make the result
// depend on the tile boundaries). Bit-exactness: the rounding helpers of
// ita_common.cuh (rintf, __fmul_rn, powers of two from exponent bits)
// and exact conversions.
#include "ita_common.cuh"

namespace {

// The arguments as separate parameters, as decode.cu's kernel takes them.
template <int DMAX, int SMAX, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
onepass_kernel(const int8_t* __restrict__ q, const ita::KvOperand kv,
               const float* __restrict__ lmult,
               const float* __restrict__ omult, const int* __restrict__ meta,
               int8_t* __restrict__ out, int sq, int bkv, int causal,
               int window, int adaptive, int n_mt, int stages) {
  const ita::AttendArgs args{q, kv, lmult, omult, meta, out, sq, bkv, causal,
                             window, adaptive, n_mt, stages, 1};
  ita::attend_block<DMAX, SMAX, WM, WN, false>(args);
}

template <int DMAX, int SMAX, int WM, int WN>
int launch_t(const ita::AttendArgs& args, int blocks, int smem,
             cudaStream_t stream) {
  auto* kernel = onepass_kernel<DMAX, SMAX, WM, WN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (blocks == 0) return 0;
  kernel<<<blocks, 32 * WM * WN, smem, stream>>>(
      args.q, args.kv, args.lmult, args.omult, args.meta, args.out, args.sq,
      args.bkv, args.causal, args.window, args.adaptive, args.n_mt,
      args.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_d(const ita::AttendArgs& args, int wm, int wn, int blocks,
             int smem, cudaStream_t st) {
  constexpr int kDecodeWN = DMAX <= 64 ? 4 : 8;
  if (args.bkv > 128)
    return launch_t<DMAX, 256, 2, 4>(args, blocks, smem, st);
  if (wm == 1 && wn == kDecodeWN)
    return launch_t<DMAX, 128, 1, kDecodeWN>(args, blocks, smem, st);
  if (wm == 4)
    return launch_t<DMAX, 128, 4, 2>(args, blocks, smem, st);
  return launch_t<DMAX, 128, 2, 4>(args, blocks, smem, st);
}

// Head dim a multiple of 16 up to 256, KV tile up to 256 keys, bh a
// multiple of kv_rep; the geometry (wm row groups of wn warps, 1 or 2
// stages) is `kernel.onepass_geometry`'s, checked here.
int launch(const void* q, const ita::KvOperand& kv, const void* lmult,
           const void* omult, const void* meta, void* out, int bh, int sq,
           int bkv, int causal, int window, int adaptive, int wm, int wn,
           int stages, void* stream) {
  const int d = kv.d;
  if (d <= 0 || d % 16 || d > ita::kMaxHeadDim || bkv <= 0 ||
      bkv > ita::kMaxTile || kv.kv_rep <= 0 || bh % kv.kv_rep ||
      !ita::block_shape_ok(wm, wn, d, bkv) || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * wm;
  const int smem = ita::layout(d, bkv, stages, rows, wn, 1).bytes;
  if (smem > ita::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long packed = static_cast<long long>(sq) * kv.kv_rep;
  const int n_mt = static_cast<int>((packed + rows - 1) / rows);
  const int blocks = bh / kv.kv_rep * n_mt;
  const ita::AttendArgs args{static_cast<const int8_t*>(q), kv,
                             static_cast<const float*>(lmult),
                             static_cast<const float*>(omult),
                             static_cast<const int*>(meta),
                             static_cast<int8_t*>(out), sq, bkv, causal,
                             window, adaptive, n_mt, stages, 1};
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_d<64>(args, wm, wn, blocks, smem, st);
  if (d <= 128) return launch_d<128>(args, wm, wn, blocks, smem, st);
  return launch_d<256>(args, wm, wn, blocks, smem, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_onepass_launch(const void* q, const void* k, const void* v,
                                  const void* lmult, const void* omult,
                                  const void* meta, void* out, int bh, int sq,
                                  int skv, int d, int bkv, int kv_4d,
                                  int kv_rep, int hq, int g, int causal,
                                  int window, int adaptive, int wm, int wn,
                                  int stages, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), skv, d, kv_rep, hq,
                          g, kv_4d};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, bkv, causal, window,
                adaptive, wm, wn, stages, stream);
}

// Paged: k/v pools (P, page, G, d), page_table (bh / hq, n_pages) int32.
extern "C" int ita_onepass_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lmult, const void* omult,
    const void* meta, void* out, int bh, int sq, int n_pages, int page,
    int d, int kv_rep, int hq, int g, int causal, int window, int adaptive,
    int wm, int wn, int stages, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k_pool),
                          static_cast<const int8_t*>(v_pool),
                          n_pages * page, d, kv_rep, hq, g, 1,
                          static_cast<const int*>(page_table), n_pages,
                          page};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, page, causal, window,
                adaptive, wm, wn, stages, stream);
}
