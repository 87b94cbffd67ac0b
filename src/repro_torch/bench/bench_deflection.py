"""Cross-pool prefill deflection study (DESIGN.md §11): ``arrow_deflect``
vs flip-only ``arrow_elastic`` on the spike trace.

Both systems share the same AutoScaler bounds and replay the identical
trace. The question is what happens *during the ramp*: a flip or a WARMING
spawn takes seconds, while deflection routes bounded prefill chunks onto
decode instances within the very next fused step. Reported per rate point:

  * goodput          — SLO-attaining requests per second of trace time
  * attainment       — fraction of requests finishing inside the SLO
  * ramp_p90_ttft    — p90 TTFT over requests arriving inside the spike
                       window (the paper's pain interval)
  * deflected/refused — DeflectionPolicy accounting (refusals by reason
                       are in results/deflection.json)

The run *asserts* the §11 headline on every point: deflection's goodput is
never below flip-only, its ramp p90 TTFT is strictly lower, and the
ratio=0 control run is byte-identical to ``arrow_elastic`` (same summary
line, decisions, and flips) — deflection off is exactly the old system.

CSV contract: name,us_per_call,derived. Full curves go to
results/deflection.json.

  PYTHONPATH=src python -m repro_torch.bench.bench_deflection
  PYTHONPATH=src python -m repro_torch.bench.bench_deflection --smoke   # CI docs job
"""
from __future__ import annotations

import argparse
import math

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.global_scheduler import DeflectionConfig
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

SCALER = dict(n_instances=4, n_prefill=2,
              autoscaler_cfg=AutoScalerConfig(min_instances=2,
                                              max_instances=12))

SYSTEMS = {
    "arrow_elastic": dict(policy="arrow_elastic", **SCALER),
    "arrow_deflect": dict(policy="arrow_deflect", **SCALER),
}

RATES = [8.0, 10.0, 12.0]


def ramp_p90_ttft(report, trace_name: str):
    """p90 TTFT (nearest-rank) over requests arriving inside the trace's
    spike window — the interval where flip-only rebalancing lags."""
    lo, hi = TRACE_PRESETS[trace_name].spike_window
    span = max((h.req.arrival for h in report.handles), default=0.0)
    vals = sorted(h.ttft for h in report.handles
                  if h.ttft is not None
                  and lo * span <= h.req.arrival < hi * span)
    if not vals:
        return None
    return vals[min(max(math.ceil(0.9 * len(vals)), 1), len(vals)) - 1]


def run_point(cfg, trace_name: str, sys_name: str, rate: float,
              duration=None, **extra):
    p = TRACE_PRESETS[trace_name]
    trace = load_trace(trace_name, rate_scale=rate, seed=0, duration=duration)
    sim = Simulator(cfg, slo=SLO(p.slo_ttft, p.slo_tpot),
                    profile=sim_profile(), **SYSTEMS[sys_name], **extra)
    replay_trace(sim, trace)
    report = sim.drain()
    span = max(report.duration, 1e-9)
    good = sum(1 for h in report.handles if h.meets_slo())
    return {
        "rate_scale": rate,
        "attainment": report.attainment,
        "goodput_req_s": good / span,
        "ramp_p90_ttft": ramp_p90_ttft(report, trace_name),
        "deflected": report.deflection.get("requests_deflected", 0),
        "refused": sum(v for k, v in report.deflection.items()
                       if k.startswith("refused_")),
        "deflection": dict(report.deflection),
        "summary": report.summary(),
        "decisions": dict(report.decisions),
        "flips": report.flips,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--trace", default="spike")
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="trace duration (seconds at scale 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="single fast point (CI docs job)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates = [10.0]
        args.duration = min(args.duration, 60.0)

    cfg = get_config(args.arch)
    out = {}
    for sys_name in SYSTEMS:
        curve = []
        with Timer() as t:
            for rate in args.rates:
                curve.append(run_point(cfg, args.trace, sys_name, rate,
                                       duration=args.duration))
        out[sys_name] = curve
        for pt in curve:
            ramp = pt["ramp_p90_ttft"]
            emit(f"deflection.{args.trace}.{sys_name}.x{pt['rate_scale']:g}",
                 t.us / len(curve),
                 f"attainment={pt['attainment']:.3f};"
                 f"goodput={pt['goodput_req_s']:.2f}req/s;"
                 f"ramp_p90_ttft={'n/a' if ramp is None else f'{ramp:.3f}s'};"
                 f"deflected={pt['deflected']};refused={pt['refused']}")

    # ---- §11 headline assertions
    for e, d in zip(out["arrow_elastic"], out["arrow_deflect"]):
        rate = e["rate_scale"]
        assert d["goodput_req_s"] >= e["goodput_req_s"] - 1e-9, (
            f"x{rate:g}: deflection goodput {d['goodput_req_s']:.3f} req/s "
            f"below flip-only {e['goodput_req_s']:.3f} req/s")
        assert d["ramp_p90_ttft"] < e["ramp_p90_ttft"], (
            f"x{rate:g}: deflection ramp p90 TTFT {d['ramp_p90_ttft']:.3f}s "
            f"not strictly below flip-only {e['ramp_p90_ttft']:.3f}s")
        gain = 1.0 - d["ramp_p90_ttft"] / e["ramp_p90_ttft"]
        emit(f"deflection.{args.trace}.ramp_gain.x{rate:g}", 0.0,
             f"ramp_p90_ttft_cut={gain:.0%};"
             f"goodput_delta={d['goodput_req_s'] - e['goodput_req_s']:+.2f}"
             f"req/s")

    # ---- ratio=0 control: deflection disarmed is *byte-identical* to
    # arrow_elastic (same scheduler decisions, flips, and summary line)
    rate = args.rates[0]
    ctl = run_point(cfg, args.trace, "arrow_deflect", rate,
                    duration=args.duration,
                    deflection=DeflectionConfig(ratio=0.0))
    ref = out["arrow_elastic"][0]
    assert not ctl["deflection"], (
        f"ratio=0 control still reports deflection: {ctl['deflection']}")
    for key in ("summary", "decisions", "flips"):
        assert ctl[key] == ref[key], (
            f"ratio=0 control diverges from arrow_elastic on {key}: "
            f"{ctl[key]!r} != {ref[key]!r}")
    emit(f"deflection.{args.trace}.control.x{rate:g}", 0.0,
         "ratio0_byte_identical=True")

    if not args.smoke:
        save_json("deflection", out)


if __name__ == "__main__":
    main()
