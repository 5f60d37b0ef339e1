"""Peaks of one NVIDIA H100 SXM5 (NVIDIA's datasheet, dense, at its
700 W limit), as the program's ``roofline/hw.py`` has them: the
configurations run float32 with TF32 off, so their matmuls and kernels
run on the CUDA cores at 67 TFLOP/s."""

PEAK_FLOPS_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
HBM_BYTES_PER_S = 3.35e12     # bytes/s
HBM_BYTES = 80 * 10 ** 9


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS_BF16 if dtype in ("bfloat16", "float16") \
        else PEAK_FLOPS_F32


def bound_s(n_bytes: float, flops: float, dtype: str = "float32") -> float:
    """The least seconds a call of this work takes: bytes over the memory
    rate against operations over the peak of its type, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops(dtype))
