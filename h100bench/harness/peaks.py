"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
