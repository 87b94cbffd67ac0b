"""Elastic-scaling study (DESIGN.md §6): goodput + provisioning cost of
``arrow_elastic`` vs the static 8-instance Arrow deployment across a request-
rate ramp on the spike/diurnal traces.

For each (trace, rate) point both systems replay the identical trace through
the unified ServingSystem API. Reported per point:

  * goodput        — SLO-attaining requests per second of trace time
  * attainment     — fraction of requests finishing inside the SLO
  * instance_s     — Σ per-instance alive seconds (the provisioning bill;
                     static pays n_instances × duration by construction)
  * goodput/inst_s — the efficiency headline: requests served in SLO per
                     instance-second paid
  * scale_ups/downs — AutoScaler actions (elastic only)

The expected picture: at low and mid rates the elastic cluster matches the
static one's attainment at a fraction of the instance-seconds (it idles at
``min_instances`` off-peak); at rates where the spike is comparable to the
scaler's reaction time (warm-up + patience + cooldown), elasticity lags and
the static over-provisioned cluster wins attainment — the trade the operator
guide quantifies (docs/OPERATOR.md).

CSV contract: name,us_per_call,derived. Full curves go to
results/elastic.json.

  PYTHONPATH=src python -m repro_torch.bench.bench_elastic
  PYTHONPATH=src python -m repro_torch.bench.bench_elastic --smoke   # CI docs job
"""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

SYSTEMS = {
    "arrow_static8": dict(policy="arrow", n_instances=8, n_prefill=4),
    "arrow_elastic": dict(policy="arrow_elastic", n_instances=4, n_prefill=2,
                          autoscaler_cfg=AutoScalerConfig(
                              min_instances=2, max_instances=12)),
}

RATES = [1.0, 2.0, 4.0, 6.0]


def run_point(cfg, trace_name: str, sys_name: str, rate: float,
              duration=None):
    p = TRACE_PRESETS[trace_name]
    trace = load_trace(trace_name, rate_scale=rate, seed=0, duration=duration)
    sim = Simulator(cfg, slo=SLO(p.slo_ttft, p.slo_tpot),
                    profile=sim_profile(), **SYSTEMS[sys_name])
    replay_trace(sim, trace)
    report = sim.drain()
    span = max(report.duration, 1e-9)
    good = sum(1 for h in report.handles if h.meets_slo())
    inst_s = report.scaling["instance_seconds"]
    return {
        "rate_scale": rate,
        "req_s": len(trace) / span,
        "attainment": report.attainment,
        "goodput_req_s": good / span,
        "instance_seconds": inst_s,
        "goodput_per_kinst_s": 1e3 * good / max(inst_s, 1e-9),
        "scale_ups": report.scaling.get("scale_ups", 0),
        "scale_downs": report.scaling.get("scale_downs", 0),
        "flips": report.flips,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--traces", nargs="*", default=["spike", "diurnal"])
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=None,
                    help="override trace duration (seconds at scale 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="single fast point per trace (CI docs job)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates = [4.0]
        args.traces = ["spike"]

    cfg = get_config(args.arch)
    out = {}
    for trace_name in args.traces:
        out[trace_name] = {}
        for sys_name in SYSTEMS:
            curve = []
            with Timer() as t:
                for rate in args.rates:
                    curve.append(run_point(cfg, trace_name, sys_name, rate,
                                           duration=args.duration))
            out[trace_name][sys_name] = curve
            for pt in curve:
                emit(f"elastic.{trace_name}.{sys_name}.x{pt['rate_scale']:g}",
                     t.us / len(curve),
                     f"attainment={pt['attainment']:.3f};"
                     f"goodput={pt['goodput_req_s']:.2f}req/s;"
                     f"instance_s={pt['instance_seconds']:.0f};"
                     f"ups={pt['scale_ups']};downs={pt['scale_downs']}")
        # headline: instance-second savings at equal-or-better attainment
        for e, s in zip(out[trace_name]["arrow_elastic"],
                        out[trace_name]["arrow_static8"]):
            if e["attainment"] >= s["attainment"] - 1e-9:
                saving = 1.0 - e["instance_seconds"] / \
                    max(s["instance_seconds"], 1e-9)
                emit(f"elastic.{trace_name}.saving.x{e['rate_scale']:g}", 0.0,
                     f"instance_s_saved={saving:.0%}")
    if not args.smoke:
        save_json("elastic", out)


if __name__ == "__main__":
    main()
