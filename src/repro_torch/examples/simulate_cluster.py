"""Cluster-scale what-if on the port's simulator: replay a production-style
trace against an 8-instance cluster of the simulator's default profile
(each instance 4 H100s) under every scheduling policy and print the
Fig. 7-style attainment table. Uses the unified ServingSystem API
(``replay_trace`` + ``drain``), the request, trace and reporting path of
the real-compute engine.

Run:  PYTHONPATH=src python -m repro_torch.examples.simulate_cluster \\
          [--trace azure_code] [--rates 4 8] [--duration 120]

The simulator runs on the host; ``--device`` is accepted, and ignored, so
every example takes the same command line.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

POLICIES = ("arrow", "minimal_load", "round_robin", "colocated")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="azure_code",
                    choices=list(TRACE_PRESETS))
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rates", nargs="*", type=float,
                    default=[4.0, 8.0, 16.0, 24.0, 32.0])
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="ignored: the simulator needs no device")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    p = TRACE_PRESETS[args.trace]
    slo = SLO(p.slo_ttft, p.slo_tpot)
    print(f"trace={args.trace} arch={args.arch} SLO(ttft={slo.ttft}s, "
          f"tpot={slo.tpot}s) 8 instances x 4 H100s (simulated)")
    print(f"{'rate':>6} {'req/s':>7} "
          + " ".join(f"{pol:>13}" for pol in POLICIES))
    for rate in args.rates:
        trace = load_trace(args.trace, rate_scale=rate, seed=0,
                           duration=args.duration)
        row = f"x{rate:<5} {len(trace) / args.duration:7.2f} "
        for pol in POLICIES:
            sim = Simulator(cfg, n_instances=8, n_prefill=4, policy=pol,
                            slo=slo)
            replay_trace(sim, trace)
            row += f" {sim.drain().attainment:12.3f}"
        print(row)
    print("\n(attainment >= 0.90 = inside the SLO target)")


if __name__ == "__main__":
    main()
