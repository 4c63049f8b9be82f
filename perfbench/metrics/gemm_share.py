"""Device time of the matrix products that cuBLAS and CUTLASS run (the
bf16 projections and the LM head) over all device time of the traced
window, in %."""

GEMM = r"gemm|nvjet|xmma|cutlass|cublas|wgmma"


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * t.seconds(GEMM) / t.device_s
