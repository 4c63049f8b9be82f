"""Plain-PyTorch oracle of the standalone ITA softmax kernel
(``repro.kernels.ita_softmax.ref``).

``ita_softmax_streaming`` of ``core/softmax.py`` implements the part-wise
DA; the kernel matches it exactly (integer equality of the underlying p
values) at the same part size. Adaptive mode streams the same DA, then
takes the adaptive DI and EN on the streamed statistics.
"""

from __future__ import annotations

import torch

from repro_torch.core import softmax as S


def ita_softmax_ref(x_q: torch.Tensor, mask: torch.Tensor, num_parts: int,
                    adaptive: bool = False) -> torch.Tensor:
    m = mask != 0
    if not adaptive:
        return S.ita_softmax_streaming(x_q, num_parts, mask=m)
    run_max, sigma = S.streaming_stats(x_q, num_parts, m)
    sigma_inv, e_r = S.adaptive_sigma_inv(sigma)
    k = torch.where(m, torch.clamp(S._k_of(x_q, run_max), max=31), 31)
    p = sigma_inv >> k
    return p.float() * S.pow2_neg(e_r)
