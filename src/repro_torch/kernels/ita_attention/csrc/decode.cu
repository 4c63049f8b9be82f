// ITA decode attention for Hopper: replaces the Pallas `decode_kernel`
// behind `ita_attention_decode` and `ita_attention_decode_paged`
// (src/repro/kernels/ita_attention/kernel.py:185-231, 388-513). The
// onepass dataflow with a single query tile (sq <= 8, the block's tile
// sized to sq): one block per row, KV tiles past the row's kv_len skipped
// (ita_common.cuh). The paged entry reads tile j of row r from pool page
// page_table[r / hq, j] (tile == page).
#include "ita_common.cuh"

namespace {

template <int BQ>
__global__ void __launch_bounds__(ita::kThreads)
decode_kernel(const int8_t* q, ita::KvOperand kv, const float* lmult,
              const float* omult, const int* meta, int8_t* out, int sq,
              int bkv, int causal, int window, int adaptive) {
  ita::attend_rows<BQ>(q, kv, lmult, omult, meta, out, sq, bkv, causal,
                       window, adaptive, blockIdx.x, 0);
}

template <int BQ>
int launch(const int8_t* q, const ita::KvOperand& kv, const float* lmult,
           const float* omult, const int* meta, int8_t* out, int bh, int sq,
           int bkv, int causal, int window, int adaptive,
           cudaStream_t stream) {
  const size_t smem = ita::smem_bytes(BQ, bkv, kv.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<BQ><<<bh, ita::kThreads, smem, stream>>>(
      q, kv, lmult, omult, meta, out, sq, bkv, causal, window, adaptive);
  return static_cast<int>(cudaGetLastError());
}

// The query tile sized to sq: 1, 2, 4 or 8 rows.
int dispatch(const void* q, const ita::KvOperand& kv, const void* lmult,
             const void* omult, const void* meta, void* out, int bh, int sq,
             int bkv, int causal, int window, int adaptive, void* stream) {
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* lm = static_cast<const float*>(lmult);
  const auto* om = static_cast<const float*>(omult);
  const auto* mp = static_cast<const int*>(meta);
  auto* op = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (sq == 1)
    return launch<1>(qp, kv, lm, om, mp, op, bh, sq, bkv, causal, window, adaptive, st);
  if (sq == 2)
    return launch<2>(qp, kv, lm, om, mp, op, bh, sq, bkv, causal, window, adaptive, st);
  if (sq <= 4)
    return launch<4>(qp, kv, lm, om, mp, op, bh, sq, bkv, causal, window, adaptive, st);
  if (sq <= 8)
    return launch<8>(qp, kv, lm, om, mp, op, bh, sq, bkv, causal, window, adaptive, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_decode_launch(const void* q, const void* k, const void* v,
                                 const void* lmult, const void* omult,
                                 const void* meta, void* out, int bh, int sq,
                                 int skv, int d, int bkv, int kv_4d,
                                 int kv_rep, int hq, int g, int causal,
                                 int window, int adaptive, void* stream) {
  const ita::KvOperand kv{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), skv, d, kv_rep, hq,
                          g, kv_4d};
  return dispatch(q, kv, lmult, omult, meta, out, bh, sq, bkv, causal, window,
                  adaptive, stream);
}

// Paged: k/v pools (P, page, G, d), page_table (bh / hq, n_pages) int32.
extern "C" int ita_decode_paged_launch(
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
  return dispatch(q, kv, lmult, omult, meta, out, bh, sq, page, causal,
                  window, adaptive, stream);
}
