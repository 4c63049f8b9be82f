// Standalone ITA softmax for Hopper: replaces the Pallas `softmax_kernel`
// behind `ita_softmax_pallas` (src/repro/kernels/ita_softmax/kernel.py:
// 26-88), the paper's softmax module alone over a materialised int8 logit
// matrix.
//
// On the TPU the grid is (row tile, pass, column tile) and the MAX/Σ
// buffers carry from one grid step to the next: pass 0 runs DA over the
// column parts (DI on the last), pass 1 re-streams the logits for EN. Here
// one warp owns one row and walks its columns twice: DA over parts of
// `bc` columns in order (the part size is part of the arithmetic: Σ is
// shifted when a later part raises the max), DI once, then EN, writing
// f32 p·2^-e_r. Rows are independent, so the TPU's row tile has no
// counterpart beyond the 8 rows of a block.
//
// What bounds it: each element is read twice (logit and mask, the second
// read from L1/L2) and written once as f32, a handful of integer ops per
// byte, so the bound is the bytes (x + mask + f32 out) over the memory
// rate. This first design reads bytes lane by lane (coalesced, not
// vectorised).
#include "../../ita_attention/csrc/ita_common.cuh"

namespace {

constexpr int kWarps = 8;   // rows per block

__global__ void __launch_bounds__(kWarps * 32)
softmax_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ mask,
               float* __restrict__ out, int r, int c, int bc, int adaptive) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= r) return;
  const int8_t* xr = x + static_cast<long long>(row) * c;
  const int8_t* mr = mask + static_cast<long long>(row) * c;

  // DA over the parts in order (all lanes hold the same m and sigma).
  int m = ita::kNegSentinel, sigma = 0;
  for (int p0 = 0; p0 < c; p0 += bc) {
    int part_max = ita::kNegSentinel;
    for (int t = p0 + lane; t < p0 + bc; t += 32)
      if (mr[t] != 0) part_max = max(part_max, static_cast<int>(xr[t]));
    const int new_max = max(m, ita::warp_max(part_max));
    const int delta = ita::da_delta(new_max, m);
    int usum = 0;
    for (int t = p0 + lane; t < p0 + bc; t += 32)
      usum += 128 >> ita::da_shift(new_max, xr[t], mr[t] != 0);
    sigma = (sigma >> delta) + 2 * ita::warp_sum(usum);
    m = new_max;
  }

  // DI once per row.
  int inv, e_r;
  if (adaptive)
    ita::adaptive_inverse(sigma, &inv, &e_r);
  else
    ita::paper_inverse(sigma, &inv, &e_r);
  const float scale = ita::pow2_neg(e_r);

  // EN: p = inv >> k, written as f32 p·2^-e_r (exact).
  float* orow = out + static_cast<long long>(row) * c;
  for (int t = lane; t < c; t += 32) {
    const int p = inv >> ita::da_shift(m, xr[t], mr[t] != 0);
    orow[t] = __fmul_rn(__int2float_rn(p), scale);
  }
}

}  // namespace

// x, mask (r, c) int8 (mask 0 = masked), out (r, c) f32; bc divides c.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ita_softmax_launch(const void* x, const void* mask, void* out,
                                  int r, int c, int bc, int adaptive,
                                  void* stream) {
  if (r <= 0) return 0;
  if (bc <= 0 || c % bc) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (r + kWarps - 1) / kWarps;
  softmax_kernel<<<blocks, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(mask),
      static_cast<float*>(out), r, c, bc, adaptive);
  return static_cast<int>(cudaGetLastError());
}
