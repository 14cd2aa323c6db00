"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

FP32_FLOPS = 67e12          # FP32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12         # HBM3, B/s
