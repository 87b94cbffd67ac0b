"""The port's legs of the engine benchmarks, run on the card by default
(``--device cuda``) or on the CPU (``--device cpu``):

  bench_engine_step  — legacy (pre-fusion) vs fused step on one burst
  bench_speculative  — self-speculative (k = 4) vs sequential decode

    PYTHONPATH=src python -m repro_torch.bench.bench_engine_step
    PYTHONPATH=src python -m repro_torch.bench.bench_speculative
"""
