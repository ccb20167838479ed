"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit). Every roofline and MFU
of the benchmark divides by these."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
TF32_FLOPS = 495e12  # tensor cores, TF32
HBM_BYTES_PER_S = 3.35e12
# Hopper SM issue rates (16 MUFU and 64 INT32 operations a clock) x 132 SMs
# at the 1.98 GHz boost clock behind the data sheet's rates
MUFU_PER_S = 132 * 16 * 1.98e9
INT32_PER_S = 132 * 64 * 1.98e9
