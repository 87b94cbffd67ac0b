"""The H100 SXM's published peaks (NVIDIA's data sheet: dense rates, the
SXM part at its 700 W limit), as the program's ``bench/common.py`` and
``bench_kernels`` use them, frozen here. A run prints the card's power
limit beside its numbers."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12            # bf16 tensor-core products
TF32X3_FLOPS = 495e12 / 3      # float32 products on the TF32 tensor cores,
#                                split hi + lo: three products a multiply-add
