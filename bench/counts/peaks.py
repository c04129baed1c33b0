"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W):
HBM3 at 3.35 TB/s and float32 outside the tensor cores at 67 TFLOP/s (the
port runs float32 with TF32 off)."""
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
