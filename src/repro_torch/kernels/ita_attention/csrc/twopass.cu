// ITA twopass attention for Hopper: replaces the two Pallas kernels behind
// `ita_attention_twopass` (src/repro/kernels/ita_attention/kernel.py:
// 133-182, 318-385), the paper's own dataflow (§III):
//
// - pass 1, `qk_da_kernel`: int8 Q·Kᵀ -> int32 -> requant onto the int8
//   logit grid; the attention matrix A is written to device memory once,
//   at every position (masked and padded ones too, as the TPU kernel
//   writes it); the streaming DA keeps the row max and Σ. On the TPU the
//   DI runs between the passes; here one block owns a row tile's whole KV
//   loop, so Σ is final at its end and the DI folds into pass 1's
//   epilogue, which writes (row max, Σ_inv, e_r).
// - pass 2, `av_en_kernel`: re-reads A, EN `p = Σ_inv >> k`, p·V, and
//   `round((f32(acc) · 2^-e_r) · omult)` to int8 (no factor 2, no +8: the
//   paper's p = 256 >> k unit, not onepass's u = 128 >> k).
//
// What bounds them: pass 1 writes A (Sq·Skv bytes per row) and pass 2
// reads it back, so at prefill shapes both are bound by the bytes of A
// over the memory rate. This first design is the simple one of
// ita_common.cuh: one block per (row, 16-query tile), an in-order loop
// over the row's KV tiles (the Σ shifts depend on the tile schedule),
// tiles staged in shared memory, Q·Kᵀ by __dp4a, p·V by int32
// multiply-adds (p <= 256 on live rows fits neither s8 nor u8, so a
// tensor-core design needs s16 or two u8 halves). The DA is skipped on
// fully masked tiles (an exact no-op); the A store never is. Pass 2 skips
// fully masked tiles (p = 0 there).
//
// p·V accumulates in int32 (exact: |acc| <= 2^(e_r+7)); the TPU kernel
// accumulates in f32, which equals it while |acc| < 2^24.
#include "ita_common.cuh"

namespace {

constexpr int kBlockQ = 16;
constexpr int kMaxOut = kBlockQ * ita::kMaxHeadDim / ita::kThreads;

// KV tiles [*j_begin, *j_end) that can hold a key visible from query rows
// [q0, q0 + kBlockQ) of a row; the others are fully masked.
__device__ __forceinline__ void visible_tiles(int kv_len, int q_off, int q0,
                                              int n_kv, int bkv, int causal,
                                              int window, int* j_begin,
                                              int* j_end) {
  int end = min((kv_len + bkv - 1) / bkv, n_kv);
  if (causal || window > 0)
    end = min(end, (q_off + q0 + kBlockQ - 1) / bkv + 1);
  *j_end = end;
  *j_begin = window > 0 ? max(q_off + q0 - window + 1, 0) / bkv : 0;
}

// Pass 1. q (BH, sq, D) int8; K through `kv` (kernel layout); lmult (BH,)
// f32; meta (BH, 3) [kv_len, q_offset, q_len]. Writes a (BH, sq, skv)
// int8 and row_max / inv / e_r (BH, sq) int32.
__global__ void __launch_bounds__(ita::kThreads)
qk_da_kernel(const int8_t* __restrict__ q, const ita::KvOperand kv,
             const float* __restrict__ lmult, const int* __restrict__ meta,
             int8_t* __restrict__ a, int* __restrict__ row_max,
             int* __restrict__ inv_out, int* __restrict__ er_out, int sq,
             int bkv, int causal, int window, int adaptive, int n_qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockQ;
  const int d = kv.d, d16 = d / 16, ks = d + 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_kv = kv.skv / bkv;

  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_k = s_q + kBlockQ * ks;
  int* s_s = reinterpret_cast<int*>(s_k + bkv * ks);   // logits
  int* s_m = s_s + kBlockQ * bkv;
  int* s_sigma = s_m + kBlockQ;

  const int kv_len = meta[3 * r];
  const int q_off = meta[3 * r + 1];
  const int q_len = meta[3 * r + 2];
  const float lm = lmult[r];

  for (int idx = tid; idx < kBlockQ * d16; idx += ita::kThreads) {
    const int i = idx / d16, c = idx % d16;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + i < sq)
      val = *reinterpret_cast<const int4*>(
          q + (static_cast<long long>(r) * sq + q0 + i) * d + c * 16);
    *reinterpret_cast<int4*>(s_q + i * ks + c * 16) = val;
  }
  if (tid < kBlockQ) {
    s_m[tid] = ita::kNegSentinel;
    s_sigma[tid] = 0;
  }
  int j_begin, j_end;
  visible_tiles(kv_len, q_off, q0, n_kv, bkv, causal, window, &j_begin,
                &j_end);
  if (q0 >= q_len) j_end = 0;           // no query row of the tile is real

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    for (int idx = tid; idx < bkv * d16; idx += ita::kThreads) {
      const int t = idx / d16, c = idx % d16;
      const long long off = ita::kv_token_offset(kv, r, j * bkv + t) + c * 16;
      *reinterpret_cast<int4*>(s_k + t * ks + c * 16) =
          *reinterpret_cast<const int4*>(kv.k + off);
    }
    __syncthreads();

    // Q·Kᵀ: thread t streams key t against every query row of the tile.
    for (int t = tid; t < bkv; t += ita::kThreads) {
      int s[kBlockQ];
#pragma unroll
      for (int i = 0; i < kBlockQ; ++i) s[i] = 0;
      for (int c = 0; c < d16; ++c) {
        const int4 kw = *reinterpret_cast<const int4*>(s_k + t * ks + c * 16);
#pragma unroll
        for (int i = 0; i < kBlockQ; ++i) {
          const int4 qw = *reinterpret_cast<const int4*>(s_q + i * ks + c * 16);
          s[i] = __dp4a(qw.x, kw.x, s[i]);
          s[i] = __dp4a(qw.y, kw.y, s[i]);
          s[i] = __dp4a(qw.z, kw.z, s[i]);
          s[i] = __dp4a(qw.w, kw.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBlockQ; ++i)
        s_s[i * bkv + t] = ita::requant_logit(s[i], lm);
    }
    __syncthreads();

    // A: every position of the tile, neighbouring threads on neighbouring
    // bytes of a row.
    for (int idx = tid; idx < kBlockQ * bkv; idx += ita::kThreads) {
      const int i = idx / bkv, t = idx % bkv;
      if (q0 + i < sq)
        a[(static_cast<long long>(r) * sq + q0 + i) * kv.skv + j * bkv + t] =
            static_cast<int8_t>(s_s[idx]);
    }
    if (j < j_begin || j >= j_end) continue;

    // DA: one warp per query row.
    for (int i = warp; i < kBlockQ; i += ita::kThreads / 32) {
      const int qli = q0 + i;
      const int qi = q_off + qli;
      const bool row_ok = qli < sq;
      const int* row = s_s + i * bkv;
      int part_max = ita::kNegSentinel;
      for (int t = lane; t < bkv; t += 32) {
        const bool ok = row_ok && ita::visible(qi, qli, j * bkv + t, causal,
                                               window, kv_len, q_len);
        part_max = max(part_max, ok ? row[t] : ita::kNegSentinel);
      }
      part_max = ita::warp_max(part_max);
      const int old_max = s_m[i];
      const int new_max = max(old_max, part_max);
      const int delta = ita::da_delta(new_max, old_max);
      int usum = 0;
      for (int t = lane; t < bkv; t += 32) {
        const bool ok = row_ok && ita::visible(qi, qli, j * bkv + t, causal,
                                               window, kv_len, q_len);
        usum += 128 >> ita::da_shift(new_max, row[t], ok);
      }
      usum = ita::warp_sum(usum);
      if (lane == 0) {
        s_sigma[i] = (s_sigma[i] >> delta) + 2 * usum;
        s_m[i] = new_max;
      }
    }
  }
  __syncthreads();

  // DI once per row (Σ is final: this block ran the row's whole KV loop).
  if (tid < kBlockQ && q0 + tid < sq) {
    int inv, e_r;
    if (adaptive)
      ita::adaptive_inverse(s_sigma[tid], &inv, &e_r);
    else
      ita::paper_inverse(s_sigma[tid], &inv, &e_r);
    const long long o = static_cast<long long>(r) * sq + q0 + tid;
    row_max[o] = s_m[tid];
    inv_out[o] = inv;
    er_out[o] = e_r;
  }
}

// Pass 2. a (BH, sq, skv) int8; row_max / inv / e_r (BH, sq) int32; V
// through `kv` (kernel layout); omult (BH,) f32; meta as pass 1. Writes
// out (BH, sq, D) int8.
__global__ void __launch_bounds__(ita::kThreads)
av_en_kernel(const int8_t* __restrict__ a, const int* __restrict__ row_max,
             const int* __restrict__ inv, const int* __restrict__ e_r,
             const ita::KvOperand kv, const float* __restrict__ omult,
             const int* __restrict__ meta, int8_t* __restrict__ out, int sq,
             int bkv, int causal, int window, int n_qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockQ;
  const int d = kv.d, d16 = d / 16;
  const int tid = threadIdx.x;
  const int n_kv = kv.skv / bkv;

  int8_t* s_v = reinterpret_cast<int8_t*>(smem);
  int* s_p = reinterpret_cast<int*>(s_v + bkv * d);
  int* s_m = s_p + kBlockQ * bkv;
  int* s_inv = s_m + kBlockQ;

  const int kv_len = meta[3 * r];
  const int q_off = meta[3 * r + 1];
  const int q_len = meta[3 * r + 2];
  const float om = omult[r];

  if (tid < kBlockQ) {
    const bool ok = q0 + tid < sq;
    const long long o = static_cast<long long>(r) * sq + q0 + tid;
    s_m[tid] = ok ? row_max[o] : 0;
    s_inv[tid] = ok ? inv[o] : 0;       // p = 0 on rows past sq
  }
  int j_begin, j_end;
  visible_tiles(kv_len, q_off, q0, n_kv, bkv, causal, window, &j_begin,
                &j_end);
  if (q0 >= q_len) j_end = 0;

  const int n_out = kBlockQ * d;
  int acc[kMaxOut];
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) acc[n] = 0;

  for (int j = j_begin; j < j_end; ++j) {
    __syncthreads();
    for (int idx = tid; idx < bkv * d16; idx += ita::kThreads) {
      const int t = idx / d16, c = idx % d16;
      const long long off = ita::kv_token_offset(kv, r, j * bkv + t) + c * 16;
      *reinterpret_cast<int4*>(s_v + t * d + c * 16) =
          *reinterpret_cast<const int4*>(kv.v + off);
    }
    // EN: p = Σ_inv >> k; masked lanes shift by kMaskK (p = 0).
    for (int idx = tid; idx < kBlockQ * bkv; idx += ita::kThreads) {
      const int i = idx / bkv, t = idx % bkv;
      const int qli = q0 + i;
      int p = 0;
      if (qli < sq) {
        const int logit =
            a[(static_cast<long long>(r) * sq + qli) * kv.skv + j * bkv + t];
        const bool ok = ita::visible(q_off + qli, qli, j * bkv + t, causal,
                                     window, kv_len, q_len);
        p = s_inv[i] >> ita::da_shift(s_m[i], logit, ok);
      }
      s_p[idx] = p;
    }
    __syncthreads();

    // acc += p·V (per tile |p·V| <= 256·128·bkv).
#pragma unroll
    for (int n = 0; n < kMaxOut; ++n) {
      const int o = tid + n * ita::kThreads;
      if (o < n_out) {
        const int i = o / d, c = o % d;
        const int* prow = s_p + i * bkv;
        int pv = 0;
        for (int t = 0; t < bkv; ++t)
          pv += prow[t] * static_cast<int>(s_v[t * d + c]);
        acc[n] += pv;
      }
    }
  }

  // round((f32(acc) · 2^-e_r) · omult), clipped to int8 (kernel.py:180).
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) {
    const int o = tid + n * ita::kThreads;
    if (o < n_out) {
      const int i = o / d, c = o % d;
      if (q0 + i < sq) {
        const long long row = static_cast<long long>(r) * sq + q0 + i;
        const float y = __fmul_rn(__int2float_rn(acc[n]),
                                  ita::pow2_neg(e_r[row]));
        out[row * d + c] = ita::requant_out(y, om);
      }
    }
  }
}

size_t qk_smem(int bkv, int d) {
  return static_cast<size_t>(kBlockQ + bkv) * (d + 16) +
         static_cast<size_t>(kBlockQ) * bkv * 4 + kBlockQ * 8;
}

size_t av_smem(int bkv, int d) {
  return static_cast<size_t>(bkv) * d +
         static_cast<size_t>(kBlockQ) * bkv * 4 + kBlockQ * 8;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// Pass 1 (B5a). q (bh, sq, d), k (bh / kv_rep, skv, d) int8; lmult (bh,)
// f32; meta (bh, 3) int32. Outputs a (bh, sq, skv) int8, row_max / inv /
// e_r (bh, sq) int32. Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_twopass_qk_launch(const void* q, const void* k,
                                     const void* lmult, const void* meta,
                                     void* a, void* row_max, void* inv,
                                     void* e_r, int bh, int sq, int skv,
                                     int d, int bkv, int kv_rep, int causal,
                                     int window, int adaptive, void* stream) {
  if (bkv <= 0 || skv % bkv || d % 16 || d > ita::kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const ita::KvOperand kv{static_cast<const int8_t*>(k), nullptr, skv, d,
                          kv_rep, 1, 1, 0};
  const size_t smem = qk_smem(bkv, d);
  if (const int e = allow_smem(qk_da_kernel, smem)) return e;
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  qk_da_kernel<<<bh * n_qt, ita::kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), kv, static_cast<const float*>(lmult),
      static_cast<const int*>(meta), static_cast<int8_t*>(a),
      static_cast<int*>(row_max), static_cast<int*>(inv),
      static_cast<int*>(e_r), sq, bkv, causal, window, adaptive, n_qt);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 (B5b). a (bh, sq, skv) int8; row_max / inv / e_r (bh, sq) int32;
// v (bh / kv_rep, skv, d) int8; omult (bh,) f32; meta (bh, 3) int32.
// Output out (bh, sq, d) int8.
extern "C" int ita_twopass_av_launch(const void* a, const void* row_max,
                                     const void* inv, const void* e_r,
                                     const void* v, const void* omult,
                                     const void* meta, void* out, int bh,
                                     int sq, int skv, int d, int bkv,
                                     int kv_rep, int causal, int window,
                                     void* stream) {
  if (bkv <= 0 || skv % bkv || d % 16 || d > ita::kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const ita::KvOperand kv{nullptr, static_cast<const int8_t*>(v), skv, d,
                          kv_rep, 1, 1, 0};
  const size_t smem = av_smem(bkv, d);
  if (const int e = allow_smem(av_en_kernel, smem)) return e;
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  av_en_kernel<<<bh * n_qt, ita::kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int*>(row_max),
      static_cast<const int*>(inv), static_cast<const int*>(e_r), kv,
      static_cast<const float*>(omult), static_cast<const int*>(meta),
      static_cast<int8_t*>(out), sq, bkv, causal, window, n_qt);
  return static_cast<int>(cudaGetLastError());
}
