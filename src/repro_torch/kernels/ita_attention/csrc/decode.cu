// ITA decode attention for Hopper: replaces the Pallas `decode_kernel`
// behind `ita_attention_decode` (B4) and `ita_attention_decode_paged`
// (B4p) (src/repro/kernels/ita_attention/kernel.py:185-231, 388-513):
// the onepass dataflow with a single query tile (sq <= 8), KV tiles past
// a row's kv_len skipped; the paged entry reads tile j of kv row kr from
// pool page page_table[kr / g, j] (tile == page), loading the page id
// once per tile.
//
// What bounds it. A decode call is small: at batch 4 on qwen2-7b it has
// 16 kv rows (4 sequences x 4 kv heads), each of 7 q heads x 1 query and
// 5 to 8 KV tiles of 128 keys; its K/V bytes take under a microsecond
// at the card's memory rate. What a block pays is the latency of its
// chain of tiles: each tile's copy from device memory, then Q·Kᵀ, the DA
// step and u·V, one after another, on 16 of 132 SMs. The first port
// (one block per q row, K/V staged by plain loads, __dp4a and an int32
// u·V loop on the scalar pipe, four barriers a tile) ran 40-50x over the
// bytes bound.
//
// This design runs ita_common.cuh's `attend_block`, the onepass kernel's
// tensor-core block:
// - Packing. One block serves one kv row: its kv_rep · sq packed rows
//   (7 at sq 1, up to 56 at sq 8), query-major, in row groups of 16
//   (1, 2 or 4 groups; past 64 packed rows, several blocks a kv row).
//   One K/V tile in shared memory serves every head of the kv row.
// - Q·Kᵀ and u·V on mma.sync m16n8k32 (s8·s8 and u8·s8 -> s32, V kept
//   token-major through ldmatrix.trans), DA on the fragments; the warps
//   of a row group split the keys for Q·Kᵀ and DA, the head dim for u·V.
// - Copies by cp.async (16 bytes) in a ring of up to 4 stages: tiles
//   j+1 .. j+3 are in flight while tile j computes.
// - A cluster over a kv row's tiles (`cluster` > 1). When the call's
//   blocks leave SMs idle, `kernel.decode_geometry` gives each kv row a
//   cluster of up to 8 CTAs; the CTAs split the row's live tiles into
//   contiguous runs, each loading its whole run at once. The running max
//   entering a tile is the prefix max of the tile maxima, so after one
//   exchange of the runs' maxima through distributed shared memory every
//   CTA computes its tiles' δ, Σu and int32 u·V exactly; the CTAs then
//   fold Σ = (Σ >> δ) + 2·Σu and acc = acc·2^-δ + u·V over the tiles in
//   order, each CTA a share of the output elements. The tile boundaries
//   and the fold order are the plain version's, so every bit is the
//   same (ita_common.cuh).
//
// The launch takes its geometry (row groups, warps per group, stages,
// cluster size) from `kernel.decode_geometry` and only checks it.
#include "ita_common.cuh"

namespace {

// The arguments as separate parameters with restrict-qualified pointers:
// one struct parameter cost the onepass kernel ~1.5 µs a launch.
template <int DMAX, int SMAX, int WM, int WN, bool CLUSTER>
__global__ void __launch_bounds__(32 * WM * WN, 2)
decode_kernel(const int8_t* __restrict__ q, const ita::KvOperand kv,
              const float* __restrict__ lmult,
              const float* __restrict__ omult, const int* __restrict__ meta,
              int8_t* __restrict__ out, int sq, int bkv, int causal,
              int window, int adaptive, int n_mt, int stages, int cluster) {
  const ita::AttendArgs args{q, kv, lmult, omult, meta, out, sq, bkv, causal,
                             window, adaptive, n_mt, stages, cluster};
  ita::attend_block<DMAX, SMAX, WM, WN, CLUSTER>(args);
}

template <int DMAX, int SMAX, int WM, int WN>
int launch_t(const ita::AttendArgs& args, int blocks, int smem,
             cudaStream_t stream) {
  auto* kernel = args.cluster > 1 ? decode_kernel<DMAX, SMAX, WM, WN, true>
                                  : decode_kernel<DMAX, SMAX, WM, WN, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (blocks == 0) return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(32 * WM * WN);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = args.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, args.q, args.kv, args.lmult, args.omult, args.meta,
      args.out, args.sq, args.bkv, args.causal, args.window, args.adaptive,
      args.n_mt, args.stages, args.cluster);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// sq <= 8, head dim a multiple of 16 up to 256, KV tile up to 256 keys
// dividing skv, bh a multiple of kv_rep; a streaming block takes 1-4
// stages, a cluster of 2-8 CTAs as many stages as a run's tiles.
int launch(const void* q, const ita::KvOperand& kv, const void* lmult,
           const void* omult, const void* meta, void* out, int bh, int sq,
           int bkv, int causal, int window, int adaptive, int wm, int wn,
           int stages, int cluster, void* stream) {
  const int d = kv.d;
  if (sq < 1 || sq > 8 || d <= 0 || d % 16 || d > ita::kMaxHeadDim ||
      bkv <= 0 || bkv > ita::kMaxTile || kv.skv % bkv || kv.kv_rep <= 0 ||
      bh % kv.kv_rep || !ita::block_shape_ok(wm, wn, d, bkv) ||
      cluster < 1 || cluster > ita::kMaxCluster || stages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = kv.skv / bkv;
  if (cluster == 1 ? stages > ita::kMaxStages
                   : stages * cluster < n_tiles || stages > n_tiles ||
                         cluster > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * wm;
  const int smem = ita::layout(d, bkv, stages, rows, wn, cluster).bytes;
  if (smem > ita::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int n_mt = (sq * kv.kv_rep + rows - 1) / rows;
  const int blocks = bh / kv.kv_rep * n_mt * cluster;
  const ita::AttendArgs args{static_cast<const int8_t*>(q), kv,
                             static_cast<const float*>(lmult),
                             static_cast<const float*>(omult),
                             static_cast<const int*>(meta),
                             static_cast<int8_t*>(out), sq, bkv, causal,
                             window, adaptive, n_mt, stages, cluster};
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_d<64>(args, wm, wn, blocks, smem, st);
  if (d <= 128) return launch_d<128>(args, wm, wn, blocks, smem, st);
  return launch_d<256>(args, wm, wn, blocks, smem, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_decode_launch(const void* q, const void* k, const void* v,
                                 const void* lmult, const void* omult,
                                 const void* meta, void* out, int bh, int sq,
                                 int skv, int d, int bkv, int kv_4d,
                                 int kv_rep, int hq, int g, int causal,
                                 int window, int adaptive, int wm, int wn,
                                 int stages, int cluster, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), skv, d, kv_rep, hq,
                          g, kv_4d};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, bkv, causal, window,
                adaptive, wm, wn, stages, cluster, stream);
}

// Paged: k/v pools (P, page, G, d), page_table (bh / hq, n_pages) int32.
extern "C" int ita_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lmult, const void* omult,
    const void* meta, void* out, int bh, int sq, int n_pages, int page,
    int d, int kv_rep, int hq, int g, int causal, int window, int adaptive,
    int wm, int wn, int stages, int cluster, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k_pool),
                          static_cast<const int8_t*>(v_pool),
                          n_pages * page, d, kv_rep, hq, g, 1,
                          static_cast<const int*>(page_table), n_pages,
                          page};
  return launch(q, kv, lmult, omult, meta, out, bh, sq, page, causal, window,
                adaptive, wm, wn, stages, cluster, stream);
}
