"""Serving launcher of the PyTorch port: one ServingSystem front-end over
both backends. Engine mode runs the real-compute Arrow cluster, on the card
by default (``--device cuda``) or on the CPU (``--device cpu``), at the
architecture's smoke-sized config as the JAX launcher's engine mode serves
it: dense archs, Mamba-2 (``--arch mamba2-370m``) and RecurrentGemma
(``--arch recurrentgemma-9b``). Sim mode runs the cluster-scale
discrete-event simulator on the host for any preset at its full config,
with the cost model's H100 profile.
``--attn-impl hopper`` routes the serving path through the hand-written
Hopper kernels (attention for dense archs, ``ssd_scan`` / ``rglru_scan``
for the recurrent ones); ``reference`` runs plain torch.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --attn-impl hopper --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --arch mamba2-370m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --device cpu --trace azure_code --rate 2 --duration 10
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --device cpu --speculate 4 --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
      --arch gemma-2b --trace azure_code --rate 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim --trace spike \
      --policy arrow_elastic --instances 4 --min-instances 2 --max-instances 12

The flags are those of the JAX launcher. ``--list-traces`` /
``--list-policies`` print the available presets/policies and exit.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.core.policies import POLICIES
from repro_torch.core.request import Request, SamplingParams
from repro_torch.core.serving import ServeReport, ServingSystem, replay_trace
from repro_torch.core.slo import SLO


def synth_requests(n: int, gap: float, vocab: int, seed: int = 0
                   ) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=float(i) * gap,
                    input_len=int(rng.integers(8, 64)),
                    output_len=int(rng.integers(2, 16)))
            for i in range(n)]


def sampling_params(args) -> Optional[SamplingParams]:
    """Build the per-request SamplingParams from the CLI (DESIGN.md §12);
    None (the default temperature 0) keeps exact greedy argmax."""
    if args.temperature <= 0.0:
        return None
    return SamplingParams(temperature=args.temperature, top_p=args.top_p,
                          seed=None)


def apply_sampling(trace: List[Request], args) -> List[Request]:
    sp = sampling_params(args)
    if sp is not None:
        for r in trace:
            r.sampling = sp
    return trace


def run_and_report(system: ServingSystem, trace: List[Request], *,
                   tier: str, label: str,
                   timeout: Optional[float] = None) -> ServeReport:
    replay_trace(system, trace, tier=tier)
    report = system.drain(timeout=timeout)
    print(f"[{label}] {report.summary()}")
    by_tier = report.attainment_by_tier()
    if len(by_tier) > 1:
        print(f"[{label}] attainment by tier: " +
              " ".join("{}={}".format(k, "n/a" if v is None else f"{v:.2f}")
                       for k, v in by_tier.items()))
    if report.per_tenant:
        print(f"[{label}] per-tenant:")
        print(report.tenant_summary())
    return report


def list_traces() -> None:
    from repro_torch.traces import TRACE_PRESETS
    print(f"{'name':<12} {'dur':>5} {'rate':>6} {'in_med':>7} {'out_med':>8} "
          f"{'corr':>5} {'slo_ttft':>9} {'slo_tpot':>9}  arrivals")
    for p in TRACE_PRESETS.values():
        shape = {"mmpp": f"MMPP x{p.burst_rate_mult:g} "
                         f"{p.burst_frac:.0%} of time",
                 "spike": f"spike x{p.shape_mult:g} over "
                          f"[{p.spike_window[0]:.0%},{p.spike_window[1]:.0%})",
                 "diurnal": f"diurnal x{p.shape_mult:g} peak",
                 "sessions": f"sessions ~{p.turns_mean:g} turns, "
                             f"think {p.think_mean:g}s",
                 "tenants": f"{p.n_tenants}+flood x{p.shape_mult:g} over "
                            f"[{p.spike_window[0]:.0%},"
                            f"{p.spike_window[1]:.0%})"}[p.rate_shape]
        print(f"{p.name:<12} {p.duration:>5.0f} {p.base_rate:>5.1f}/s "
              f"{p.in_median:>7.0f} {p.out_median:>8.0f} {p.in_out_corr:>5.2f} "
              f"{p.slo_ttft:>8.2f}s {p.slo_tpot:>8.3f}s  {shape}")
    print("\n(see repro/traces/synth.py for provenance; --rate divides "
          "inter-arrival times, §7.1)")


def list_policies() -> None:
    print(f"{'name':<16} {'adaptive':>8} {'elastic':>8}  summary")
    for name, cls in POLICIES.items():
        doc = (cls.__doc__ or "").strip().splitlines()[0]
        print(f"{name:<16} {str(cls.adaptive):>8} "
              f"{str(getattr(cls, 'elastic', False)):>8}  {doc}")
    print("\n(arrow_proactive = arrow + SchedulerConfig.proactive burst "
          "detection)")


def run_engine(args) -> ServeReport:
    from repro_torch.engine import ArrowEngineCluster
    cfg = get_smoke_config(args.arch).replace(attn_impl=args.attn_impl)
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise SystemExit("--mode engine supports dense/ssm/hybrid archs; "
                         "the other families are not ported yet")
    cluster = ArrowEngineCluster(cfg, n_instances=args.instances,
                                 n_prefill=max(args.instances // 2, 1),
                                 n_slots=8, capacity=256,
                                 slo=SLO(args.ttft, args.tpot),
                                 policy=args.policy, seed=args.seed,
                                 speculate=args.speculate,
                                 autoscaler_cfg=autoscaler_cfg(args),
                                 prefix_cache=args.prefix_cache == "on",
                                 fault_plan=fault_plan(args),
                                 tenants=tenant_registry(args),
                                 admission=args.admission == "on",
                                 deflection=deflection_cfg(args),
                                 health=health_cfg(args),
                                 device=args.device)
    if args.trace:
        from repro_torch.traces import load_trace
        trace = load_trace(args.trace, rate_scale=args.rate, seed=0,
                           duration=args.duration)
    else:
        trace = synth_requests(args.requests, args.gap, cfg.vocab_size)
    trace = apply_sampling(trace, args)
    return run_and_report(cluster, trace, tier=args.tier,
                          timeout=args.timeout,
                          label=f"serve-engine {args.policy}")


def run_sim(args) -> ServeReport:
    from repro_torch.sim import Simulator
    from repro_torch.traces import TRACE_PRESETS, load_trace
    cfg = get_config(args.arch)
    trace_name = args.trace or "azure_code"
    p = TRACE_PRESETS[trace_name]
    trace = load_trace(trace_name, rate_scale=args.rate, seed=0,
                       duration=args.duration)
    sim = Simulator(cfg, n_instances=args.instances,
                    n_prefill=max(args.instances // 2, 1),
                    policy=args.policy, slo=SLO(p.slo_ttft, p.slo_tpot),
                    seed=args.seed, speculate=args.speculate,
                    autoscaler_cfg=autoscaler_cfg(args),
                    prefix_cache=args.prefix_cache == "on",
                    fault_plan=fault_plan(args),
                    tenants=tenant_registry(args),
                    admission=args.admission == "on",
                    deflection=deflection_cfg(args),
                    health=health_cfg(args))
    trace = apply_sampling(trace, args)
    # no timeout: --timeout is wall-clock; the sim's drain limit is virtual
    # time and must cover the whole trace
    return run_and_report(sim, trace, tier=args.tier,
                          label=f"serve-sim {args.arch} {trace_name} "
                                f"x{args.rate} {args.policy}")


def fault_plan(args) -> Optional[FaultPlan]:
    """Parse ``--fault-plan`` (DESIGN.md §8); None = no injection."""
    if args.fault_plan is None:
        return None
    return FaultPlan.parse(args.fault_plan)


def tenant_registry(args):
    """Build the ``--tenants`` roster (DESIGN.md §10); None = the implicit
    single tenant. ``--admission on`` without ``--tenants`` still arms the
    controller (every request lands on the auto-registered 'anonymous'
    tenant)."""
    if args.tenants is None:
        return None
    from repro_torch.core.tenants import default_registry
    return default_registry(args.tenants)


def deflection_cfg(args):
    """Build the ``--deflection`` config (DESIGN.md §11); None keeps the
    policy's defaults (``arrow_deflect`` arms DeflectionConfig() on its own;
    non-deflective policies reject an explicit config)."""
    if args.deflection != "on" and args.deflect_ratio is None:
        return None
    from repro_torch.core.global_scheduler import DeflectionConfig
    base = DeflectionConfig()
    return DeflectionConfig(**{
        **base.__dict__,
        "ratio": base.ratio if args.deflect_ratio is None
        else args.deflect_ratio,
    })


def health_cfg(args):
    """Build the self-healing layer's config (DESIGN.md §14); None/False
    keeps the layer off — byte-identical to pre-health builds. ``--preemption
    on`` implies ``--health on`` (preemption rides the health config)."""
    if args.health != "on" and args.preemption != "on":
        return False
    from repro_torch.core.health import HealthConfig
    base = HealthConfig()
    return HealthConfig(**{
        **base.__dict__,
        "straggler_factor": base.straggler_factor
        if args.quarantine_factor is None else args.quarantine_factor,
        "sustain_s": base.sustain_s
        if args.quarantine_sustain is None else args.quarantine_sustain,
        "preemption": args.preemption == "on",
    })


def autoscaler_cfg(args) -> Optional[AutoScalerConfig]:
    """AutoScaler bounds from the CLI; None keeps the policy's defaults
    (non-elastic policies reject an explicit config)."""
    if args.min_instances is None and args.max_instances is None:
        return None
    base = AutoScalerConfig()
    return AutoScalerConfig(**{
        **base.__dict__,
        "min_instances": base.min_instances if args.min_instances is None
        else args.min_instances,
        "max_instances": base.max_instances if args.max_instances is None
        else args.max_instances,
    })


def build_parser() -> argparse.ArgumentParser:
    """The launcher's full CLI surface: the JAX launcher's flags (this
    package's own copy), with ``--attn-impl reference|hopper``,
    and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("engine", "sim"), default="engine")
    ap.add_argument("--arch", "--model-arch", choices=ARCH_IDS,
                    default="qwen3-1.7b",
                    help="architecture preset (--model-arch is an alias); "
                         "the PyTorch engine serves the dense, ssm and "
                         "hybrid families; sim mode models any preset")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--gap", type=float, default=0.05)
    ap.add_argument("--ttft", type=float, default=5.0)
    ap.add_argument("--tpot", type=float, default=2.0)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--trace", default=None,
                    help="replay a repro_torch.traces preset (both "
                         "modes); engine default is synthetic requests, "
                         "sim default azure_code")
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--policy", default="arrow", choices=sorted(POLICIES))
    ap.add_argument("--tier", default="standard",
                    choices=("interactive", "standard", "batch"))
    ap.add_argument("--min-instances", type=int, default=None,
                    help="AutoScaler floor (elastic policies only)")
    ap.add_argument("--max-instances", type=int, default=None,
                    help="AutoScaler ceiling (elastic policies only)")
    ap.add_argument("--fault-plan", default=None,
                    help="inject faults (DESIGN.md §8): ';'-separated "
                         "events, e.g. 'crash@20;crash@45:target=3;"
                         "slow@60:factor=4,duration=5'. Crashed instances "
                         "lose their KV; the runtime recovers the lost "
                         "requests (and an elastic policy replaces the "
                         "instance)")
    ap.add_argument("--attn-impl", choices=("reference", "hopper"),
                    default="reference",
                    help="engine-mode attention implementation: "
                         "'reference' = plain-torch sdpa; 'hopper' = the "
                         "hand-written flash_prefill/paged_attention CUDA "
                         "kernels (their plain-torch versions with "
                         "--device cpu); sim mode ignores this flag")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda; "
                         "pass cpu to run without a card); sim mode runs "
                         "on the host and ignores it")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="prefix-aware KV reuse (DESIGN.md §7): retain "
                         "finished contexts and prefill only the uncached "
                         "suffix of multi-turn / repeated prompts")
    ap.add_argument("--tenants", type=int, default=None,
                    help="multi-tenant serving (DESIGN.md §10): register N "
                         "well-behaved tenants t0..t{N-1} (tiers cycling "
                         "interactive/standard/batch) plus the adversarial "
                         "'flood' tenant the 'tenants' trace preset drives; "
                         "requests carry tenant ids from the trace")
    ap.add_argument("--admission", choices=("on", "off"), default="off",
                    help="credit-based admission control (DESIGN.md §10): "
                         "watermark guard over cluster pressure — admit "
                         "all below the low watermark, credit-gate with "
                         "deadline-aware retries between watermarks, shed "
                         "above the high watermark")
    ap.add_argument("--deflection", choices=("on", "off"), default="off",
                    help="cross-pool prefill deflection (DESIGN.md §11), "
                         "requires --policy arrow_deflect: above the Eq.(1) "
                         "pressure watermark, decode instances absorb "
                         "bounded prefill chunks in-step (and idle prefill "
                         "instances pick up decode slack), refused whenever "
                         "the predictors say it would break the victim "
                         "pool's SLO budget")
    ap.add_argument("--deflect-ratio", type=float, default=None,
                    help="§11 micro-batch knob: max deflected prefill "
                         "tokens per fused step as a fraction of the "
                         "victim's mixed-chunk budget (default 0.25; 0 "
                         "disables deflection — byte-identical to "
                         "arrow_elastic). Implies --deflection on")
    ap.add_argument("--health", choices=("on", "off"), default="off",
                    help="self-healing layer (DESIGN.md §14): straggler "
                         "detection against the fleet-median TPOT, "
                         "quarantine (DEGRADED — never schedulable, decode "
                         "residents drained), probation back to ACTIVE when "
                         "the signal clears, escalation to a crash after "
                         "the quarantine deadline; also arms the transfer "
                         "retry ladder (checksummed migrations, bounded "
                         "exponential backoff). Off = byte-identical to "
                         "pre-health builds")
    ap.add_argument("--quarantine-factor", type=float, default=None,
                    help="§14 straggler threshold: quarantine when an "
                         "instance's recent token interval sustains above "
                         "this multiple of the fleet median (default 3.0; "
                         "hysteresis clears at 1.5x)")
    ap.add_argument("--quarantine-sustain", type=float, default=None,
                    help="§14 sustain window: seconds the straggler signal "
                         "must persist before quarantine (default 2.0; "
                         "transients shorter than this never quarantine)")
    ap.add_argument("--preemption", choices=("on", "off"), default="off",
                    help="SLO-aware preemption (DESIGN.md §14): when the "
                         "§5.4 memory gate refuses a migration and eviction "
                         "cannot free enough KV, preempt the lowest-value "
                         "decode resident (by tenant credits, then tier, "
                         "then remaining length) and re-dispatch it through "
                         "crash recovery — streams stay bit-identical. "
                         "Rate-limited per instance; implies --health on")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (DESIGN.md §12); 0 = exact "
                         "greedy argmax (the default). Sampled streams are "
                         "replayable: same trace + --seed => bit-identical "
                         "tokens, across runs, step modes, migration and "
                         "crash recovery")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (only with "
                         "--temperature > 0): sample from the smallest "
                         "prefix of the sorted distribution holding at "
                         "least this probability")
    ap.add_argument("--seed", type=int, default=0,
                    help="run seed recorded in the report; per-request "
                         "sampling keys derive statelessly from (seed, rid, "
                         "position), so replaying a trace with the same "
                         "seed reproduces every sampled stream bit-for-bit")
    ap.add_argument("--speculate", type=int, default=0,
                    help="self-speculative decoding (DESIGN.md §12): draft "
                         "k tokens per round with the truncated-layer "
                         "model, verify in one full pass, emit the longest "
                         "agreeing prefix + 1 — streams stay bit-identical "
                         "to non-speculative decoding; 0 disables. Engine "
                         "mode runs it in the fused step; sim mode models "
                         "the round cost and acceptance analytically")
    ap.add_argument("--list-traces", action="store_true",
                    help="print the trace-preset table and exit")
    ap.add_argument("--list-policies", action="store_true",
                    help="print the policy registry and exit")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.list_traces:
        return list_traces()
    if args.list_policies:
        return list_policies()
    if args.mode == "engine":
        run_engine(args)
    else:
        if args.trace is None:
            args.trace = "azure_code"
        run_sim(args)


if __name__ == "__main__":
    main()
