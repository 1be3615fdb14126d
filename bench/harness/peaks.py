"""The yardstick's peaks: one NVIDIA H100 SXM as its data sheet states it
(dense rates, no sparsity, at the full 700 W power limit).  Copied here
from the program's ``hw.py`` so that no later change to the program moves
the benchmark's rooflines."""

BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12      # HBM3
