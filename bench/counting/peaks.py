"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit): 989e12 bf16 tensor-core FLOP/s and 3.35e12
bytes/s of HBM3."""
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
