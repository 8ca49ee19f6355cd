"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_seconds(bytes_moved: float, flops: float, flop_peak: float = FP32_FLOPS) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / flop_peak)
