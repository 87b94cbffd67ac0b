"""Multi-tenant admission study (DESIGN.md §10): does credit-based
admission control actually protect well-behaved tenants from an
adversarial flooder?

Three deterministic simulator runs per rate point on the ``tenants`` trace
(4 well-behaved tenants + the ``flood`` tenant ramping 10x mid-trace), all
under ``arrow_elastic`` on a capacity-capped cluster (the point where
elastic scale-up alone cannot absorb the flood):

  * off   — the tenancy subsystem disarmed: no registry, no admission,
            plain FIFO dispatch. The flooder's backlog head-of-line
            blocks everyone.
  * wdrr  — registry armed, admission off: weighted deficit round-robin
            dispatch isolates prefill queues but admits everything.
  * full  — registry + credit admission: the flooder's own SLO violations
            drain its credits; its excess is deferred, then rejected or
            shed at the watermarks.

Headline (asserted so the bench can't rot): at the top rate point the
*full* leg keeps every well-behaved tenant's attainment >= 0.9 while the
*off* leg drops at least one below 0.6 — and the full leg does it with
fewer instance-seconds (shedding is cheaper than scaling into a flood).

CSV contract: name,us_per_call,derived. Full curves go to
results/tenants.json.

  PYTHONPATH=src python -m repro_torch.bench.bench_tenants
  PYTHONPATH=src python -m repro_torch.bench.bench_tenants --smoke   # CI docs job
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.core.tenants import default_registry
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

RATES = [16.0, 24.0, 32.0]
MODES = ("off", "wdrr", "full")
WELL_BEHAVED = ("t0", "t1", "t2", "t3")


def run_point(cfg, rate: float, mode: str, duration: float):
    p = TRACE_PRESETS["tenants"]
    trace = load_trace("tenants", rate_scale=rate, seed=0, duration=duration)
    kw = {}
    if mode != "off":
        kw = dict(tenants=default_registry(4),
                  admission=(mode == "full"))
    sim = Simulator(cfg, n_instances=4, n_prefill=2, policy="arrow_elastic",
                    slo=SLO(p.slo_ttft, p.slo_tpot),
                    autoscaler_cfg=AutoScalerConfig(min_instances=2,
                                                    max_instances=6),
                    profile=sim_profile(), **kw)
    replay_trace(sim, trace)
    report = sim.drain()
    # per-tenant attainment computed uniformly from handles (the `off` leg
    # has no registry, so report.per_tenant is empty there by design)
    by = {}
    for h in report.handles:
        by.setdefault(h.req.tenant_id, []).append(h)
    tenants = {}
    for tid, hs in sorted(by.items()):
        fin = [h for h in hs if h.req.finish_time is not None]
        tenants[tid] = {
            "submitted": len(hs),
            "finished": len(fin),
            "attainment": (sum(h.meets_slo() for h in fin) / len(fin)
                           if fin else None),
            "rejected": sum(1 for h in hs if h.rejected),
        }
    return {
        "rate_scale": rate,
        "mode": mode,
        "n_requests": len(trace),
        "attainment": report.attainment,
        "instance_s": report.scaling["instance_seconds"],
        "admission": report.admission,
        "tenants": tenants,
        "per_tenant": report.per_tenant,   # credits etc. (registry legs)
    }


def min_well_behaved(pt) -> float:
    return min(pt["tenants"][t]["attainment"] or 0.0 for t in WELL_BEHAVED)


def flood_rejections(pt) -> int:
    return pt["tenants"].get("flood", {}).get("rejected", 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=120.0,
                    help="trace duration (seconds at scale 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="single fast point (CI docs job): relative checks "
                         "only, no JSON artifact")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates, args.duration = [16.0], 40.0

    cfg = get_config(args.arch)
    out = {}
    for mode in MODES:
        curve = []
        with Timer() as t:
            for rate in args.rates:
                curve.append(run_point(cfg, rate, mode, args.duration))
        out[mode] = curve
        for pt in curve:
            emit(f"tenants.{mode}.x{pt['rate_scale']:g}",
                 t.us / len(curve),
                 f"min_wb_attainment={min_well_behaved(pt):.2f};"
                 f"flood_rejected={flood_rejections(pt)};"
                 f"instance_s={pt['instance_s']:.0f}")

    # headline: the subsystem must protect the compliant tenants under the
    # heaviest flood, and rejection must actually be exercised
    for off, full in zip(out["off"], out["full"]):
        assert flood_rejections(full) > 0, \
            "admission never rejected the flooder — the gate is dead"
        assert min_well_behaved(full) >= 0.9, \
            (f"admission-on dropped a well-behaved tenant to "
             f"{min_well_behaved(full):.2f} at x{full['rate_scale']:g}")
        emit(f"tenants.headline.x{full['rate_scale']:g}", 0.0,
             f"wb_off={min_well_behaved(off):.2f};"
             f"wb_full={min_well_behaved(full):.2f};"
             f"instance_s_off={off['instance_s']:.0f};"
             f"instance_s_full={full['instance_s']:.0f}")
    if args.smoke:
        off, full = out["off"][-1], out["full"][-1]
        assert min_well_behaved(off) < min_well_behaved(full) - 0.1, \
            "admission showed no protection over the FIFO baseline"
        print("tenants smoke OK:",
              f"wb {min_well_behaved(off):.2f} -> "
              f"{min_well_behaved(full):.2f}", file=sys.stderr)
        return
    # full run: the top rate point must show the collapse admission avoids
    top_off = out["off"][-1]
    assert min_well_behaved(top_off) < 0.6, \
        (f"FIFO baseline survived the flood (min well-behaved "
         f"{min_well_behaved(top_off):.2f}) — raise the rate so the bench "
         f"measures an actual overload")
    save_json("tenants", out)


if __name__ == "__main__":
    main()
