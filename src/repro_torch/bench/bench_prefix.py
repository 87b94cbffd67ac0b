"""Prefix-reuse study (DESIGN.md §7): goodput and prefill-seconds saved of
``arrow`` with the prefix cache on vs off, on the multi-turn conversation
trace — plus a control showing the non-session presets (spike) are untouched
when the cache is off.

For each rate point the identical ``multiturn`` trace replays through two
simulators differing only in ``prefix_cache``. Reported per point:

  * goodput          — SLO-attaining requests per second of trace time
  * attainment       — fraction of requests finishing inside the SLO
  * prefill_saved    — predicted prefill-seconds not recomputed, as a
                       fraction of the total predicted prefill time
                       (``ServeReport.prefix['saved_prefill_frac']``)
  * hit_rate         — index hits / lookups
  * p50/p90 TTFT     — the latency the reuse actually buys

Expected picture: every follow-up turn hits (hit_rate ≈ share of follow-up
turns), well over 30% of prefill seconds are saved (the shared history
dominates the prompt), and goodput with the cache on is >= the cache-off run
at every rate — at high rates, where the prefill queue is the bottleneck,
the gap is largest.

CSV contract: name,us_per_call,derived. Full curves go to
results/prefix.json.

  PYTHONPATH=src python -m repro_torch.bench.bench_prefix
  PYTHONPATH=src python -m repro_torch.bench.bench_prefix --smoke   # CI docs job
"""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

SYSTEMS = {
    "arrow": dict(prefix_cache=False),
    "arrow_prefix": dict(prefix_cache=True),
}

RATES = [2.0, 4.0, 6.0]


def run_point(cfg, trace_name: str, sys_name: str, rate: float,
              duration=None):
    p = TRACE_PRESETS[trace_name]
    trace = load_trace(trace_name, rate_scale=rate, seed=0, duration=duration)
    sim = Simulator(cfg, n_instances=8, n_prefill=4, policy="arrow",
                    slo=SLO(p.slo_ttft, p.slo_tpot), profile=sim_profile(),
                    **SYSTEMS[sys_name])
    replay_trace(sim, trace)
    report = sim.drain()
    span = max(report.duration, 1e-9)
    good = sum(1 for h in report.handles if h.meets_slo())
    px = report.prefix
    return {
        "rate_scale": rate,
        "n_requests": len(trace),
        "attainment": report.attainment,
        "goodput_req_s": good / span,
        "p50_ttft": report.percentile("ttft", 0.5),
        "p90_ttft": report.percentile("ttft", 0.9),
        "prefill_saved_frac": px.get("saved_prefill_frac", 0.0),
        "hits": px.get("hits", 0),
        "lookups": px.get("lookups", 0),
        "evictions": px.get("evictions", 0),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=None,
                    help="override trace duration (seconds at scale 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="single fast point (CI docs job)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates = [4.0]
        args.duration = args.duration or 120.0

    cfg = get_config(args.arch)
    out = {}
    for sys_name in SYSTEMS:
        curve = []
        with Timer() as t:
            for rate in args.rates:
                curve.append(run_point(cfg, "multiturn", sys_name, rate,
                                       duration=args.duration))
        out[sys_name] = curve
        for pt in curve:
            emit(f"prefix.multiturn.{sys_name}.x{pt['rate_scale']:g}",
                 t.us / len(curve),
                 f"attainment={pt['attainment']:.3f};"
                 f"goodput={pt['goodput_req_s']:.2f}req/s;"
                 f"p90_ttft={pt['p90_ttft'] * 1e3:.1f}ms;"
                 f"saved={pt['prefill_saved_frac']:.0%};"
                 f"hits={pt['hits']:.0f}/{pt['lookups']:.0f}")
    # headline: goodput delta + prefill-seconds saved at each rate
    for on, off in zip(out["arrow_prefix"], out["arrow"]):
        emit(f"prefix.multiturn.headline.x{on['rate_scale']:g}", 0.0,
             f"goodput_delta={on['goodput_req_s'] - off['goodput_req_s']:+.2f}"
             f"req/s;prefill_s_saved={on['prefill_saved_frac']:.0%}")
    # control: a non-session preset with the cache *off* is byte-identical
    # to plain arrow (same code path) — assert instead of just reporting
    p = TRACE_PRESETS["spike"]
    spike = load_trace("spike", rate_scale=2.0, seed=0,
                       duration=args.duration)
    ttfts = []
    for kw in (dict(), dict(prefix_cache=False)):
        sim = Simulator(cfg, n_instances=8, n_prefill=4, policy="arrow",
                        slo=SLO(p.slo_ttft, p.slo_tpot), profile=sim_profile(),
                        **kw)
        replay_trace(sim, spike)
        rep = sim.drain()
        ttfts.append([h.ttft for h in rep.handles])
    assert ttfts[0] == ttfts[1], "cache-off run diverged from plain arrow"
    emit("prefix.spike.cache_off_control", 0.0, "identical=yes")
    if not args.smoke:
        save_json("prefix", out)


if __name__ == "__main__":
    main()
