"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit; the run prints the card's own limit beside them)."""

PEAK_BF16_FLOPS = 989e12     # tensor cores, bfloat16 / float16 inputs
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
CARD = "NVIDIA H100 80GB HBM3"
