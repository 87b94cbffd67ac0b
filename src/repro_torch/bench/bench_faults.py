"""Fault-tolerance study (DESIGN.md §8): goodput retention under injected
instance crashes, against a no-recovery strawman.

Three deterministic simulator runs per rate point on the spike trace, all
under ``arrow_elastic`` (the AutoScaler replaces crashed instances):

  * baseline     — fault-free
  * recovery     — the same trace with two scripted crashes; lost requests
                   are re-dispatched (KV-loss recovery, §8.2)
  * strawman     — the same crashes with recovery disabled: in-flight
                   requests on the dead instance are stranded for good

Reported per point: attainment, goodput (SLO-attaining requests per second
of trace time), goodput *retention* vs the fault-free baseline, requests
recovered/lost, and the re-prefill tokens recovery paid. Expected picture:
recovery retains >= ~90% of fault-free goodput (it loses only the recompute
and queueing of the lost work) while the strawman permanently forfeits every
stranded request — and every recovery run finishes all requests.

CSV contract: name,us_per_call,derived. Full curves go to
results/faults.json.

  PYTHONPATH=src python -m repro_torch.bench.bench_faults
  PYTHONPATH=src python -m repro_torch.bench.bench_faults --smoke   # CI docs job
"""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

RATES = [2.0, 4.0, 6.0]
PLAN = "crash@15;crash@30"          # inside the 60 s spike window


def run_point(cfg, rate: float, mode: str, duration: float):
    p = TRACE_PRESETS["spike"]
    trace = load_trace("spike", rate_scale=rate, seed=0, duration=duration)
    plan = None
    if mode != "baseline":
        plan = FaultPlan.parse(PLAN, recovery=(mode == "recovery"))
    sim = Simulator(cfg, n_instances=6, n_prefill=3, policy="arrow_elastic",
                    slo=SLO(p.slo_ttft, p.slo_tpot),
                    autoscaler_cfg=AutoScalerConfig(min_instances=2,
                                                    max_instances=12),
                    fault_plan=plan, profile=sim_profile())
    replay_trace(sim, trace)
    report = sim.drain()
    span = max(report.duration, 1e-9)
    good = sum(1 for h in report.handles if h.meets_slo())
    f = report.faults
    return {
        "rate_scale": rate,
        "n_requests": len(trace),
        "n_finished": report.n_finished,
        "attainment": report.attainment,
        "goodput_req_s": good / span,
        "recovered": f.get("requests_recovered", 0),
        "lost": f.get("requests_lost", 0),
        "re_prefill_tokens": f.get("re_prefill_tokens", 0),
        "replacements": f.get("replacements", 0),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="trace duration (seconds at scale 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="single fast point (CI docs job)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates = [4.0]

    cfg = get_config(args.arch)
    out = {}
    for mode in ("baseline", "recovery", "strawman"):
        curve = []
        with Timer() as t:
            for rate in args.rates:
                curve.append(run_point(cfg, rate, mode, args.duration))
        out[mode] = curve
        for pt in curve:
            emit(f"faults.spike.{mode}.x{pt['rate_scale']:g}",
                 t.us / len(curve),
                 f"attainment={pt['attainment']:.3f};"
                 f"goodput={pt['goodput_req_s']:.2f}req/s;"
                 f"finished={pt['n_finished']}/{pt['n_requests']};"
                 f"recovered={pt['recovered']:.0f};lost={pt['lost']:.0f}")
    # headline: goodput retention vs fault-free, recovery vs strawman
    for rec, straw, base in zip(out["recovery"], out["strawman"],
                                out["baseline"]):
        denom = max(base["goodput_req_s"], 1e-9)
        r_ret = rec["goodput_req_s"] / denom
        s_ret = straw["goodput_req_s"] / denom
        # recovery must complete everything and dominate the strawman — the
        # whole point of the subsystem; assert so the bench can't rot
        assert rec["n_finished"] == rec["n_requests"], "recovery lost requests"
        assert rec["goodput_req_s"] >= straw["goodput_req_s"], \
            "recovery underperformed the no-recovery strawman"
        emit(f"faults.spike.headline.x{rec['rate_scale']:g}", 0.0,
             f"retention_recovery={r_ret:.0%};"
             f"retention_strawman={s_ret:.0%};"
             f"re_prefill_toks={rec['re_prefill_tokens']:.0f}")
    if not args.smoke:
        save_json("faults", out)


if __name__ == "__main__":
    main()
