// Shared device code of the ITA attention kernels for Hopper (sm_90a).
//
// Replaces the body shared by the Pallas kernels `onepass_kernel` and
// `decode_kernel` (src/repro/kernels/ita_attention/kernel.py:79-130,
// 185-231) and their helpers in src/repro/kernels/common.py:113-190:
// int8 Q·Kᵀ -> int32 -> requant onto the int8 logit grid, the streaming
// DA step (running max, Σ, u = 128 >> k), acc = acc·2^-δ + u·V, and DI at
// the last tile folded into the int8 output requant.
//
// The helpers (mask, requant, DA shifts, DIs, powers of two) serve every
// attention kernel: onepass.cu's tensor-core kernel (B2, B3) and
// `attend_rows` below.
//
// `attend_rows` now serves only the decode kernel (decode.cu: B4, B4p).
// It is the first port's simple design: one block per (row, q tile), a
// loop over KV tiles inside the block (the TPU grid's sequential axis;
// the integer Σ shifts make the result depend on the KV tile schedule,
// so KV is never split across blocks), K/V tiles staged in shared memory
// by plain loads, Q·Kᵀ by __dp4a, u·V by int32 multiply-adds, and an f32
// accumulator in registers. Fully masked KV tiles (beyond kv_len, above
// the causal diagonal, left of the window) are exact no-ops of the DA
// step and are skipped. What bounds it: its scalar products and its
// synchronous copies, not the K/V bytes of a decode row (its times are
// about 50x its bytes bound on the H100, PERF.md); onepass.cu's design
// (heads of a kv head packed into one tile, mma.sync, cp.async) is
// what a redesign of the decode kernel would start from.
//
// Bit-exactness with the JAX package: round half to even (rintf), every
// product that feeds a rounding is an explicit __fmul_rn (no contraction),
// powers of two are built from exponent bits, shifts are taken only on
// non-negative operands and amounts in [0, 31].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ita {

constexpr int kNegSentinel = -256;   // masked-logit fill
constexpr int kMaskK = 31;           // shift of a masked element: 128 >> 31 == 0
constexpr int kSoftmaxShift = 5;
constexpr int kSigmaInvMax = 256;
constexpr int kPaperInvMax = 1 << 16;
constexpr int kThreads = 128;        // threads per block
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

// tile_mask: query qi (logical position; qli its index in the row) sees
// key kj.
__device__ __forceinline__ bool visible(int qi, int qli, int kj, int causal,
                                        int window, int kv_len, int q_len) {
  bool ok = kj < kv_len && qli < q_len;
  if (causal || window > 0) ok = ok && qi >= kj;
  if (window > 0) ok = ok && (qi - kj) < window;
  return ok;
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

// Dynamic shared memory of one block: Q tile and K tile with rows padded
// by 16 bytes (conflict-free 16-byte reads), V tile, the logits/u tile,
// and four per-row vectors.
__host__ __device__ inline size_t smem_bytes(int bq, int bkv, int d) {
  const size_t ks = static_cast<size_t>(d) + 16;
  return bq * ks + bkv * ks + static_cast<size_t>(bkv) * d +
         static_cast<size_t>(bq) * bkv * 4 + static_cast<size_t>(bq) * 16;
}

// One block computes query rows [q0, q0 + BQ) of kernel row r.
// q (BH, sq, D) int8; lmult/omult (BH,) f32; meta (BH, 3) int32
// [kv_len, q_offset, q_len]; out (BH, sq, D) int8.
template <int BQ>
__device__ void attend_rows(const int8_t* __restrict__ q, const KvOperand kv,
                            const float* __restrict__ lmult,
                            const float* __restrict__ omult,
                            const int* __restrict__ meta,
                            int8_t* __restrict__ out, int sq, int bkv,
                            int causal, int window, int adaptive, int r,
                            int q0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = kv.d;
  const int d16 = d / 16;
  const int ks = d + 16;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_k = s_q + BQ * ks;
  int8_t* s_v = s_k + bkv * ks;
  int* s_s = reinterpret_cast<int*>(s_v + bkv * d);   // logits, then u
  int* s_m = s_s + BQ * bkv;
  int* s_sigma = s_m + BQ;
  float* s_corr = reinterpret_cast<float*>(s_sigma + BQ);
  float* s_scale = s_corr + BQ;

  const int kv_len = meta[3 * r];
  const int q_off = meta[3 * r + 1];
  const int q_len = meta[3 * r + 2];
  const float lm = lmult[r];
  const float om = omult[r];

  // A tile whose query rows all lie past the row's q_len (the padding of
  // a decode row in a ragged mixed call) sees no key: its output is 0,
  // exactly what the tile loop would give, so skip the loop.
  if (q0 >= q_len) {
    for (int idx = tid; idx < BQ * d; idx += kThreads) {
      const int i = idx / d, c = idx % d;
      if (q0 + i < sq)
        out[(static_cast<long long>(r) * sq + q0 + i) * d + c] = 0;
    }
    return;
  }

  for (int idx = tid; idx < BQ * d16; idx += kThreads) {
    const int i = idx / d16, c = idx % d16;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + i < sq)
      val = *reinterpret_cast<const int4*>(
          q + (static_cast<long long>(r) * sq + q0 + i) * d + c * 16);
    *reinterpret_cast<int4*>(s_q + i * ks + c * 16) = val;
  }
  if (tid < BQ) {
    s_m[tid] = kNegSentinel;
    s_sigma[tid] = 0;
  }

  // Each thread owns outputs o = tid + n * kThreads of the (BQ, d) tile.
  constexpr int kMaxOut = (BQ * kMaxHeadDim + kThreads - 1) / kThreads;
  const int n_out = BQ * d;
  float acc[kMaxOut];
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) acc[n] = 0.f;

  // KV tiles that can hold a visible key; the others are no-ops.
  int j_end = min((kv_len + bkv - 1) / bkv, kv.skv / bkv);
  if (causal || window > 0) j_end = min(j_end, (q_off + q0 + BQ - 1) / bkv + 1);
  int j_begin = 0;
  if (window > 0) j_begin = max(q_off + q0 - window + 1, 0) / bkv;

  for (int j = j_begin; j < j_end; ++j) {
    __syncthreads();
    for (int idx = tid; idx < bkv * d16; idx += kThreads) {
      const int t = idx / d16, c = idx % d16;
      const long long off = kv_token_offset(kv, r, j * bkv + t) + c * 16;
      *reinterpret_cast<int4*>(s_k + t * ks + c * 16) =
          *reinterpret_cast<const int4*>(kv.k + off);
      *reinterpret_cast<int4*>(s_v + t * d + c * 16) =
          *reinterpret_cast<const int4*>(kv.v + off);
    }
    __syncthreads();

    // Q·Kᵀ: thread t streams key t against every query row of the tile.
    for (int t = tid; t < bkv; t += kThreads) {
      int s[BQ];
#pragma unroll
      for (int i = 0; i < BQ; ++i) s[i] = 0;
      for (int c = 0; c < d16; ++c) {
        const int4 kw = *reinterpret_cast<const int4*>(s_k + t * ks + c * 16);
#pragma unroll
        for (int i = 0; i < BQ; ++i) {
          const int4 qw = *reinterpret_cast<const int4*>(s_q + i * ks + c * 16);
          s[i] = __dp4a(qw.x, kw.x, s[i]);
          s[i] = __dp4a(qw.y, kw.y, s[i]);
          s[i] = __dp4a(qw.z, kw.z, s[i]);
          s[i] = __dp4a(qw.w, kw.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < BQ; ++i) s_s[i * bkv + t] = requant_logit(s[i], lm);
    }
    __syncthreads();

    // DA: one warp per query row.
    for (int i = warp; i < BQ; i += kThreads / 32) {
      const int qli = q0 + i;
      const int qi = q_off + qli;
      const bool row_ok = qli < sq;
      int* row = s_s + i * bkv;
      int part_max = kNegSentinel;
      for (int t = lane; t < bkv; t += 32) {
        const bool ok = row_ok && visible(qi, qli, j * bkv + t, causal,
                                          window, kv_len, q_len);
        part_max = max(part_max, ok ? row[t] : kNegSentinel);
      }
      part_max = warp_max(part_max);
      const int old_max = s_m[i];
      const int new_max = max(old_max, part_max);
      const int delta = da_delta(new_max, old_max);
      int usum = 0;
      for (int t = lane; t < bkv; t += 32) {
        const bool ok = row_ok && visible(qi, qli, j * bkv + t, causal,
                                          window, kv_len, q_len);
        const int u = 128 >> da_shift(new_max, row[t], ok);
        row[t] = u;
        usum += u;
      }
      usum = warp_sum(usum);
      __syncwarp();
      if (lane == 0) {
        s_sigma[i] = (s_sigma[i] >> delta) + 2 * usum;
        s_m[i] = new_max;
        s_corr[i] = pow2_neg(delta);
      }
    }
    __syncthreads();

    // acc = acc · 2^-δ + u·V (u·V exact in int32: |Σ| <= 128·128·bkv).
#pragma unroll
    for (int n = 0; n < kMaxOut; ++n) {
      const int o = tid + n * kThreads;
      if (o < n_out) {
        const int i = o / d, c = o % d;
        const int* urow = s_s + i * bkv;
        int pv = 0;
        for (int t = 0; t < bkv; ++t)
          pv += urow[t] * static_cast<int>(s_v[t * d + c]);
        acc[n] = __fadd_rn(__fmul_rn(acc[n], s_corr[i]), __int2float_rn(pv));
      }
    }
  }
  __syncthreads();

  // DI once per row, folded into the output requant.
  if (tid < BQ) {
    int inv, e_r;
    if (adaptive)
      adaptive_inverse(s_sigma[tid], &inv, &e_r);
    else
      paper_inverse(s_sigma[tid], &inv, &e_r);
    s_scale[tid] = out_scale(inv, e_r, om);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) {
    const int o = tid + n * kThreads;
    if (o < n_out) {
      const int i = o / d, c = o % d;
      if (q0 + i < sq)
        out[(static_cast<long long>(r) * sq + q0 + i) * d + c] =
            requant_out(acc[n], s_scale[i]);
    }
  }
}

}  // namespace ita
