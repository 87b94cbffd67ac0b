"""The port's benchmarks, one module per paper table/figure, in the order
``run.py`` runs them (that of ``benchmarks/run.py``, less its race of the
JAX engine's two step modes: the port has one). Each prints
``name,us_per_call,derived`` CSV lines.

The simulator benches run on the host, on ``repro_torch.sim`` with the
profile of ``common.sim_profile`` (the H100's by default):

  Fig.1/2  bench_trace_stats       workload diversity of synthesized traces
  Fig.4    bench_load_difference   prefill load leads decode load
  Fig.7    bench_e2e               Arrow vs vLLM / vLLM-disagg / DistServe
  Fig.8    bench_ablation          SLO-aware vs minimal-load vs round-robin
  Fig.9    bench_scalability       attainment vs instance count
  (ours)   bench_flip_latency      a per-flip penalty vs the stateless flip
  (ours)   bench_elastic           elastic vs static provisioning (DESIGN §6)
  (ours)   bench_deflection        cross-pool prefill deflection vs flip-only (DESIGN §11)
  (ours)   bench_prefix            prefix-aware KV reuse on multi-turn (DESIGN §7)
  (ours)   bench_faults            goodput under crashes vs no-recovery (DESIGN §8)
  (ours)   bench_tenants           credit admission vs FIFO under a flooder (DESIGN §10)

The engine legs and the kernels run on the card by default (``--device
cuda``) or on the CPU (``--device cpu``):

  (ours)   bench_chaos             self-healing vs detection-off under chaos (DESIGN §14)
  (ours)   bench_speculative       self-speculative (k = 4) vs sequential decode
  (ours)   bench_ssm               SSM/recurrent decode-state serving economics (DESIGN §13)
  (ours)   bench_kernels           the five Hopper kernels vs their plain versions
  (ours)   roofline                terms from repro_torch.launch.dryrun's records

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.bench_e2e --duration 60
"""
