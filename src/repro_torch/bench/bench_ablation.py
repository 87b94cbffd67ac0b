"""Paper Fig. 8 (§7.3 ablation): SLO-Aware (Arrow) vs Minimal-Load vs
Round-Robin, 4P+4D instances, azure_code + azure_conv."""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

# arrow_proactive = beyond-paper extension (burst-detector pre-flipping)
STRATEGIES = ["arrow", "arrow_proactive", "minimal_load", "round_robin"]
RATES = [2.0, 4.0, 8.0, 12.0, 16.0, 24.0, 32.0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--duration", type=float, default=120.0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)

    out = {}
    for trace_name in ("azure_code", "azure_conv"):
        p = TRACE_PRESETS[trace_name]
        out[trace_name] = {}
        sustain = {}
        for strat in STRATEGIES:
            curve = []
            with Timer() as t:
                for rate in RATES:
                    trace = load_trace(trace_name, rate_scale=rate, seed=0,
                                       duration=args.duration)
                    sim = Simulator(cfg, n_instances=8, n_prefill=4,
                                    policy=strat, slo=SLO(p.slo_ttft, p.slo_tpot),
                                    profile=sim_profile(chips=4))
                    replay_trace(sim, trace)
                    res = sim.drain()
                    curve.append({"rate_scale": rate,
                                  "req_s": len(trace) / args.duration,
                                  "attainment": res.attainment,
                                  "flips": res.flips})
            out[trace_name][strat] = curve
            best = max((c["req_s"] for c in curve if c["attainment"] >= 0.9),
                       default=0.0)
            sustain[strat] = best
            emit(f"ablation.{trace_name}.{strat}", t.us,
                 f"max_rate@90%={best:.2f}req/s")
        if sustain["minimal_load"]:
            emit(f"ablation.{trace_name}.slo_aware_vs_minimal", 0.0,
                 f"speedup={sustain['arrow'] / sustain['minimal_load']:.2f}x")
    save_json("ablation", out)


if __name__ == "__main__":
    main()
