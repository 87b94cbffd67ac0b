"""Paper Fig. 9: SLO attainment of SLO-Aware vs Minimal-Load under varying
instance counts, scaled to cluster sizes where scheduler *host* overhead
becomes the story.

Two parts:

  * the Fig. 9 sweep — attainment for ``arrow`` vs ``minimal_load`` at
    2..64 instances over a shared trace;
  * a scheduler-overhead budget point — one 64-instance / 100k-request
    replay (``arrow``) asserting the host-side cost per scheduling decision
    stays within budget. The global scheduler is O(instances) per placement
    and the event loop O(log events) per token, so per-request overhead must
    stay flat as the cluster grows; a super-linear regression (e.g. an
    accidental O(instances) scan per *token*) blows the budget immediately.

Budgets are ~10x the measured baseline (≈220 us/request, ≈5.5 us/token on a
dev box) so only algorithmic regressions — not CI machine jitter — trip them.

``--smoke`` shrinks both parts for CI but keeps every assertion live.
"""
from __future__ import annotations

import argparse

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.traces import TRACE_PRESETS, load_trace

# host-overhead ceilings for the budget point (see module docstring)
US_PER_REQUEST_BUDGET = 2000.0
US_PER_TOKEN_BUDGET = 50.0


def run_point(cfg, n: int, trace, slo: SLO, policy: str):
    with Timer() as t:
        sim = Simulator(cfg, n_instances=n, n_prefill=max(n // 2, 1),
                        policy=policy, slo=slo,
                        profile=sim_profile(chips=4))
        replay_trace(sim, trace)
        report = sim.drain()
    assert report.n_finished == len(trace), \
        f"scalability run dropped requests at n={n}"
    return report, t


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: 2-instance sweep + ~1.5k-request "
                         "overhead point; same assertions")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    p = TRACE_PRESETS["azure_code"]
    slo = SLO(p.slo_ttft, p.slo_tpot)

    # ---------------------------------------------------- Fig. 9 sweep
    sweep_ns = (2, 4) if args.smoke else (2, 4, 8, 16, 32, 64)
    duration = 10.0 if args.smoke else args.duration
    trace = load_trace("azure_code", rate_scale=args.rate, seed=0,
                       duration=duration)
    out = {}
    for n in sweep_ns:
        out[n] = {}
        for strat in ("arrow", "minimal_load"):
            report, t = run_point(cfg, n, trace, slo, strat)
            out[n][strat] = report.attainment
            emit(f"scalability.n{n}.{strat}", t.us,
                 f"attainment={report.attainment:.3f}")

    # --------------------------------- scheduler-overhead budget point
    n_big = 8 if args.smoke else 64
    big_rate, big_dur = (150.0, 10.0) if args.smoke else (800.0, 100.0)
    big = load_trace("azure_code", rate_scale=big_rate, seed=0,
                     duration=big_dur)
    if not args.smoke:
        assert len(big) >= 100_000, \
            f"overhead trace too small: {len(big)} requests"
    report, t = run_point(cfg, n_big, big, slo, "arrow")
    tokens = sum(len(h.tokens) for h in report.handles)
    us_req = t.us / len(big)
    us_tok = t.us / max(tokens, 1)
    emit(f"scalability.overhead.n{n_big}", t.us,
         f"requests={len(big)} us_per_request={us_req:.1f} "
         f"us_per_token={us_tok:.2f}")
    assert us_req < US_PER_REQUEST_BUDGET, (
        f"scheduler host overhead {us_req:.0f} us/request exceeds the "
        f"{US_PER_REQUEST_BUDGET:.0f} us budget at {n_big} instances")
    assert us_tok < US_PER_TOKEN_BUDGET, (
        f"event-loop overhead {us_tok:.1f} us/token exceeds the "
        f"{US_PER_TOKEN_BUDGET:.0f} us budget at {n_big} instances")
    out["overhead"] = {"n": n_big, "requests": len(big),
                       "us_per_request": us_req, "us_per_token": us_tok}
    save_json("scalability", out)


if __name__ == "__main__":
    main()
