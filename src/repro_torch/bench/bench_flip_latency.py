"""Motivation quantified (§3.2 'lagging instance scheduling'): the same
adaptive policy with a non-zero per-flip penalty (model reload / drain, as in
DistServe/Splitwise/TetriInfer) vs Arrow's zero-cost stateless flip."""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

LATENCIES = [0.0, 5.0, 30.0, 120.0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--duration", type=float, default=120.0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    p = TRACE_PRESETS["azure_code"]
    trace = load_trace("azure_code", rate_scale=args.rate, seed=0,
                       duration=args.duration)
    out = {}
    for lat in LATENCIES:
        with Timer() as t:
            sim = Simulator(cfg, n_instances=8, n_prefill=4, policy="arrow",
                            slo=SLO(p.slo_ttft, p.slo_tpot), flip_latency=lat,
                            profile=sim_profile())
            replay_trace(sim, trace)
            res = sim.drain()
        out[lat] = {"attainment": res.attainment, "flips": res.flips}
        emit(f"flip_latency.{lat:g}s", t.us,
             f"attainment={res.attainment:.3f};flips={res.flips}")
    save_json("flip_latency", out)


if __name__ == "__main__":
    main()
