// ITA onepass attention for Hopper: replaces the Pallas `onepass_kernel`
// behind `ita_attention_onepass` and `ita_attention_onepass_paged`
// (src/repro/kernels/ita_attention/kernel.py:79-130, 265-315, 516-564).
// Grid: one block per (row, 16-query tile); each block loops over the
// row's KV tiles (ita_common.cuh). The paged entry reads tile j of row r
// from pool page page_table[r / hq, j] (tile == page), the same schedule
// as the ring, so paged and ring outputs are equal bit for bit.
#include "ita_common.cuh"

namespace {

constexpr int kBlockQ = 16;

__global__ void __launch_bounds__(ita::kThreads)
onepass_kernel(const int8_t* q, ita::KvOperand kv, const float* lmult,
               const float* omult, const int* meta, int8_t* out, int sq,
               int bkv, int causal, int window, int adaptive, int n_qt) {
  const int r = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockQ;
  ita::attend_rows<kBlockQ>(q, kv, lmult, omult, meta, out, sq, bkv, causal,
                            window, adaptive, r, q0);
}

int launch(const void* q, const ita::KvOperand& kv, const void* lmult,
           const void* omult, const void* meta, void* out, int bh, int sq,
           int bkv, int causal, int window, int adaptive, void* stream) {
  const size_t smem = ita::smem_bytes(kBlockQ, bkv, kv.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  onepass_kernel<<<bh * n_qt, ita::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), kv, static_cast<const float*>(lmult),
      static_cast<const float*>(omult), static_cast<const int*>(meta),
      static_cast<int8_t*>(out), sq, bkv, causal, window, adaptive, n_qt);
  return static_cast<int>(cudaGetLastError());
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
