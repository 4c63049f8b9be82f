# The port's kernels for the compute hot spots ITA optimizes in silicon:
# the quantized attention pipeline (Q·Kᵀ -> integer streaming softmax ->
# A·V) and the int8 linear layers. Each subpackage holds a CUDA kernel,
# its plain PyTorch version and a public wrapper (``ops``).
from repro_torch.kernels.int8_matmul.ops import int8_matmul  # noqa: F401
from repro_torch.kernels.ita_softmax.ops import ita_softmax  # noqa: F401
from repro_torch.kernels.ita_attention.ops import fused_attention  # noqa: F401
