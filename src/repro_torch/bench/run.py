"""Benchmark runner of the port — one function per paper table/figure, in
the order of ``benchmarks/run.py`` (less its race of the JAX engine's two
step modes: the port has one). Prints ``name,us_per_call,derived`` CSV
lines. ``BENCH_FAST=1`` shortens the simulator traces to 60 s and runs the
engine legs at their smoke sizes; ``--device`` (default ``cuda``) is the
device of the three engine legs and of ``bench_kernels``.

  PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]
  BENCH_FAST=1 PYTHONPATH=src python -m repro_torch.bench.run --device cpu

The modules are listed in ``repro_torch/bench/__init__.py``.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the engine legs' and bench_kernels' device: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]
    fast = os.environ.get("BENCH_FAST", "")
    duration = "60" if fast else "120"
    smoke = ["--smoke"] if fast else []

    from repro_torch.bench import (bench_ablation, bench_chaos,
                                   bench_deflection, bench_e2e,
                                   bench_elastic, bench_faults,
                                   bench_flip_latency, bench_kernels,
                                   bench_load_difference, bench_prefix,
                                   bench_scalability, bench_speculative,
                                   bench_ssm, bench_tenants,
                                   bench_trace_stats, roofline)
    from repro_torch.launch.dryrun import load_results
    print("name,us_per_call,derived")
    bench_trace_stats.main()
    bench_load_difference.main()
    bench_e2e.main(["--duration", duration])
    bench_ablation.main(["--duration", duration])
    bench_scalability.main(["--duration", duration])
    bench_flip_latency.main(["--duration", duration])
    bench_elastic.main(["--duration", duration])
    bench_deflection.main(["--duration", duration])
    bench_prefix.main(["--duration", duration])
    bench_faults.main([])
    bench_chaos.main(smoke + dev)
    # needs its full 120 s window: the FIFO collapse the headline asserts
    # takes that long to build, so BENCH_FAST does not shorten it
    bench_tenants.main([])
    bench_speculative.main(smoke + dev)
    bench_ssm.main(smoke + dev)
    bench_kernels.main(dev)
    try:
        roofline.main([])
    except Exception as e:  # noqa: BLE001
        if load_results():
            raise
        # no dry-run records yet: repro_torch.launch.dryrun writes them
        print(f"roofline,0,skipped({type(e).__name__})", file=sys.stderr)


if __name__ == "__main__":
    main()
