"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): HBM3 bandwidth, and the rate of operations by the type
of their operands, float32 on the CUDA cores and bfloat16 on the tensor
cores."""
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over the operands' peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOP_PER_S[dtype])
