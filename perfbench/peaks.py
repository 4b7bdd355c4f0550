"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W power limit). A share of a peak is stated against these, with
the card's name and power limit beside it."""
HBM_BYTES_PER_S = 3.35e12      # HBM3
BF16_FLOPS = 989e12            # tensor cores, dense
TF32_FLOPS = 495e12            # tensor cores, dense
FP32_FLOPS = 67e12             # outside the tensor cores
