"""Self-healing chaos study, the port's leg of ``benchmarks/bench_chaos.py``:
goodput under a combined slowdown + dropped-transfer + crash storm, with
the health layer on against a detection-off control, then the same kind of
storm on the port's real engine.

Two deterministic simulator runs (``repro_torch.sim``, its default H100
profile) per rate point on the ``spike`` trace, both under
``arrow_elastic`` with the same fault plan, the JAX bench's with the
straggler's slowdown taken from the simulator's profile
(``straggler_factor``):

  * healing: the health layer on; the straggler is quarantined and drained
    after ``sustain_s``, dropped transfers climb the retry ladder, and the
    memory gate may preempt;
  * control: detection off; the straggler keeps its residents for the
    whole slow window and every dropped transfer falls straight through to
    re-prefill recovery.

The headline asserts healing goodput strictly above the control at every
point, at least one quarantine, and every quarantined instance back to
ACTIVE, or the bench fails.

The engine leg (``run_engine_leg``) replays a small chaos plan (transfer
drops + netslow + a crash) on the port's ``ArrowEngineCluster`` and asserts
every stream, greedy and seeded-sampled, equal to the fault-free
sequential ``EngineInstance`` reference: recovery and retries may change
when tokens appear, never which. Its weights come from a
``torch.Generator`` (seed 7) on the device, or from the caller (the tests
carry the JAX package's across). On the CPU the smoke config, on the card
the published one, float32 by default: in bf16 a row's bits follow its
batch, so a recovered stream can leave the reference at a near tie.

CSV contract: name,us_per_call,derived; a full run writes
``results/chaos.json`` beside this file.

  PYTHONPATH=src python -m repro_torch.bench.bench_chaos
  PYTHONPATH=src python -m repro_torch.bench.bench_chaos --smoke --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.common import Timer, device_info, emit, save_json
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import HealthConfig
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.sim import Simulator
from repro_torch.sim.cost_model import CostModel
from repro_torch.traces import TRACE_PRESETS, load_trace

RATES = [4.0, 5.0]


def straggler_factor(cfg, slo_tpot: float) -> int:
    """The least whole slowdown that takes every decode step of the
    straggler out of the TPOT SLO on this simulator's profile (one request
    at context 1 is the cheapest step an instance takes), so that keeping
    the straggler's residents costs goodput and quarantining it can pay.
    The default H100 profile prices that gemma-2b step at 2.58 ms, so the
    spike SLO of 0.1 s gives 39. The JAX plan's 8 keeps the straggler
    inside the SLO on this profile and on the JAX package's own."""
    return int(slo_tpot // CostModel(cfg).iteration_time([], [1])) + 1


def plan(slow_factor: float) -> str:
    # instance 4 sits in the decode pool (prefill is 0..2): the slowdown is
    # pinned there so the straggler is always detectable from decode
    # intervals
    return (f"slow@10:factor={slow_factor:g},duration=20,target=4;"
            "droptransfer@15:p=0.6,duration=10;"
            "crash@30")


HEALTH = HealthConfig(sustain_s=1.0, probation_s=2.0,
                      xfer_backoff_s=0.05, preemption=True)
ENGINE_PLAN = ("droptransfer@0.05:p=0.7,duration=1;"
               "netslow@0.2:factor=3,duration=1;"
               "crash@1.0:target=2")


def run_point(cfg, rate: float, healing: bool, duration: float,
              slow_factor: Optional[float] = None):
    p = TRACE_PRESETS["spike"]
    if slow_factor is None:
        slow_factor = straggler_factor(cfg, p.slo_tpot)
    trace = load_trace("spike", rate_scale=rate, seed=0, duration=duration)
    sim = Simulator(cfg, n_instances=6, n_prefill=3, policy="arrow_elastic",
                    slo=SLO(p.slo_ttft, p.slo_tpot),
                    autoscaler_cfg=AutoScalerConfig(min_instances=2,
                                                    max_instances=12),
                    fault_plan=FaultPlan.parse(plan(slow_factor)),
                    health=HEALTH if healing else False)
    replay_trace(sim, trace)
    report = sim.drain()
    assert not sim.pools.degraded_ids(), \
        "an instance was left quarantined after drain"
    span = max(report.duration, 1e-9)
    good = sum(1 for h in report.handles if h.meets_slo())
    done = [h for h in report.handles if h.tpot is not None]
    h = report.health
    return {
        "rate_scale": rate,
        "n_requests": len(trace),
        "n_finished": report.n_finished,
        "attainment": report.attainment,
        "goodput_req_s": good / span,
        # what the misses were: TTFT (queueing, as after a crash) or TPOT
        # (decoding on the straggler)
        "ttft_misses": sum(x.ttft > p.slo_ttft for x in done),
        "tpot_misses": sum(x.tpot > p.slo_tpot for x in done),
        "quarantines": h.get("quarantines", 0),
        "restores": h.get("restores", 0),
        "xfer_retries": h.get("xfer_retries", 0),
        "xfer_failures": h.get("xfer_failures", 0),
        "preemptions": h.get("preemptions", 0),
        "recovered": report.faults.get("requests_recovered", 0),
    }


def engine_prompts(cfg, n: int, size: int = 16):
    rng = np.random.default_rng(5)
    return {i: rng.integers(1, cfg.vocab_size, size=size).astype(np.int32)
            for i in range(n)}


def reference_streams(cfg, params, prompts, outs, device, *, sampling=None,
                      run_seed: int = 0, capacity: int = 128):
    """The fault-free sequential streams: request ``rid`` alone on one
    ``EngineInstance``, ``prompts[rid]`` then ``outs[rid]`` tokens, greedy
    unless ``sampling`` maps it to ``SamplingParams`` (a sampled stream's
    keys follow the run seed and the rid)."""
    from repro_torch.engine import EngineInstance
    ref = EngineInstance(99, cfg, params, n_slots=1, capacity=capacity,
                         run_seed=run_seed, device=device)
    out = {}
    for rid, prompt in prompts.items():
        ref.set_sampling(rid, (sampling or {}).get(rid))
        got = [ref.run_prefill(rid, prompt)]
        ref.local.start_local_decode(rid, len(prompt), outs[rid] - 1)
        for _ in range(outs[rid] - 1):
            got.append(ref.run_decode_iteration([rid])[rid])
        out[rid] = [int(t) for t in got]
        ref.drop(rid)
    return out


def run_engine_leg(cfg, params, device, *, plan: str = ENGINE_PLAN,
                   late=None):
    """Real-cluster chaos replay: ``plan`` under the health layer
    (``xfer_backoff_s=0.01``) on three instances (prefill 0, decode 1 and
    2) of 4 x 128, 6 requests of 16 prompt tokens and 12 outputs due at
    once (odd rids sampled at temperature 0.8 / top-p 0.9, run seed 3);
    ``late`` = (arrival s, output tokens) adds one more request, due
    later, so a timed fault still finds the cluster serving on a fast
    device. Every stream is compared with the fault-free sequential
    reference. Returns the counts, the report and the streams."""
    from repro_torch.core import Request, SamplingParams
    from repro_torch.engine import ArrowEngineCluster
    run_seed, n = 3, 6
    total = n + (late is not None)
    prompts = engine_prompts(cfg, total)
    outs = {i: 12 for i in range(n)}
    arrivals = {i: 0.0 for i in range(n)}
    if late is not None:
        arrivals[n], outs[n] = late
    sp = SamplingParams(temperature=0.8, top_p=0.9)
    sampling = {i: sp for i in range(total) if i % 2}
    eng = ArrowEngineCluster(
        cfg, n_instances=3, n_prefill=1, n_slots=4, capacity=128,
        slo=SLO(5.0, 2.0), params=params, seed=run_seed,
        health=HealthConfig(xfer_backoff_s=0.01),
        fault_plan=FaultPlan.parse(plan), device=device)
    handles = [eng.submit(Request(rid=i, arrival=arrivals[i],
                                  input_len=len(prompts[i]),
                                  output_len=outs[i],
                                  sampling=sampling.get(i)),
                          prompt=prompts[i]) for i in range(total)]
    report = eng.drain(timeout=300.0)
    assert report.n_finished == total, "engine chaos leg lost requests"
    streams = {h.rid: [int(t) for t in h.tokens] for h in handles}
    ref = reference_streams(cfg, params, prompts, outs, device,
                            sampling=sampling, run_seed=run_seed)
    mismatched = [rid for rid in streams if streams[rid] != ref[rid]]
    hd = report.health
    counts = {
        "n_requests": total,
        "n_sampled": len(sampling),
        "mismatched_streams": len(mismatched),
        "mismatched_rids": mismatched,
        "xfer_drops": hd.get("xfer_drops", 0),
        "xfer_retries": hd.get("xfer_retries", 0),
        "xfer_corrupt": hd.get("xfer_corrupt", 0),
        "xfer_failures": hd.get("xfer_failures", 0),
        "crashes": report.faults.get("crashes", 0),
        "requests_recovered": report.faults.get("requests_recovered", 0),
    }
    return counts, report, streams


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    help="the simulator legs' arch (published config)")
    ap.add_argument("--rates", nargs="*", type=float, default=RATES)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="trace duration (seconds at scale 1.0)")
    ap.add_argument("--device", default="cuda",
                    help="the engine leg's device: cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32",
                    help="the engine leg's dtype (float32: the identity "
                         "check holds)")
    ap.add_argument("--slow-factor", type=float, default=None,
                    help="the straggler's slowdown (default: the least that "
                         "leaves the spike TPOT SLO on the profile; the JAX "
                         "bench's is 8)")
    ap.add_argument("--smoke", action="store_true",
                    help="one rate point")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rates = [4.0]
    from repro_torch.engine.instance import resolve_device
    from repro_torch.weights import init_params
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    out = {}
    for mode, healing in (("healing", True), ("control", False)):
        curve = []
        with Timer() as t:
            for rate in args.rates:
                curve.append(run_point(cfg, rate, healing, args.duration,
                                       args.slow_factor))
        out[mode] = curve
        for pt in curve:
            emit(f"chaos.spike.{mode}.x{pt['rate_scale']:g}",
                 t.us / len(curve),
                 f"attainment={pt['attainment']:.3f};"
                 f"goodput={pt['goodput_req_s']:.2f}req/s;"
                 f"finished={pt['n_finished']}/{pt['n_requests']};"
                 f"quarantines={pt['quarantines']:.0f};"
                 f"retries={pt['xfer_retries']:.0f};"
                 f"misses_ttft={pt['ttft_misses']};"
                 f"misses_tpot={pt['tpot_misses']}")
    # headline: the self-healing loop must pay for itself at every point
    for heal, ctl in zip(out["healing"], out["control"]):
        assert heal["n_finished"] == heal["n_requests"], \
            "healing run lost requests"
        assert heal["quarantines"] >= 1, "no quarantine fired: plan is stale"
        assert heal["restores"] >= heal["quarantines"], \
            "a quarantined instance never returned to ACTIVE"
        assert heal["goodput_req_s"] > ctl["goodput_req_s"], (
            f"healing did not beat detection-off control at "
            f"x{heal['rate_scale']:g}: {heal['goodput_req_s']:.3f} <= "
            f"{ctl['goodput_req_s']:.3f}")
        ratio = heal["goodput_req_s"] / max(ctl["goodput_req_s"], 1e-9)
        emit(f"chaos.spike.headline.x{heal['rate_scale']:g}", 0.0,
             f"goodput_gain={ratio:.2f}x;"
             f"quarantines={heal['quarantines']:.0f};"
             f"restores={heal['restores']:.0f};"
             f"retries={heal['xfer_retries']:.0f};"
             f"preemptions={heal['preemptions']:.0f}")

    ecfg = (get_smoke_config("qwen3-1.7b") if dev.type == "cpu"
            else get_config("qwen3-1.7b")).replace(attn_impl="hopper",
                                                   dtype=args.dtype)
    params = init_params(ecfg, torch.Generator(device=dev.type).manual_seed(7),
                         dev)
    with Timer() as t:
        eng, _, _ = run_engine_leg(ecfg, params, dev)
    out["engine"] = eng
    assert eng["mismatched_streams"] == 0, \
        "a healed engine stream diverged from the fault-free reference"
    name, power = device_info(dev)
    emit("chaos.engine.identity", t.us,
         f"streams={eng['n_requests']}({eng['n_sampled']}sampled);"
         f"mismatched={eng['mismatched_streams']};"
         f"drops={eng['xfer_drops']:.0f};retries={eng['xfer_retries']:.0f};"
         f"crashes={eng['crashes']:.0f};{ecfg.dtype} on {name}"
         + (f" ({power})" if power else ""))
    if not args.smoke:
        out["device"], out["power_limit"] = name, power
        save_json("chaos", out)


if __name__ == "__main__":
    main()
