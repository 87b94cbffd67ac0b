"""Synthetic workload traces statistically matched to the four production
traces the paper evaluates on (Fig. 1/2, §3.1), plus two elasticity presets
(spike/diurnal) exercising the AutoScaler (DESIGN.md §6) and a multi-turn
conversation preset (multiturn) exercising the prefix cache (DESIGN.md §7).
The originals are not redistributable; generation is seeded and targets the
published moments.

Preset provenance and target moments (at ``rate_scale=1.0``):

  name        provenance                    rate    in_med  out_med  corr  arrivals
  ----------  ----------------------------  ------  ------  -------  ----  -----------------
  azure_code  Azure LLM code trace (paper   2.0/s   2600    28       0.95  MMPP, 10x bursts
              Fig. 1: c_v≈0.8/min, long                                    10% of time
              inputs, short outputs)
  azure_conv  Azure LLM conversation trace  4.0/s   1024    220      0.29  MMPP, 2.5x bursts
              (moderate lengths, weak                                      15% of time
              in/out correlation)
  burstgpt    BurstGPT open trace (the      3.0/s   620     190      0.55  MMPP, 8x bursts
              burstiest: c_v≈1.11/min)                                     10% of time
  mooncake    Mooncake production trace     3.0/s   14000   300      0.40  Poisson (stable,
              (very long inputs, stable                                    c_v≈0.16)
              load)
  spike       synthetic elasticity study:   1.0/s   1800    160      0.50  6x plateau over
              flash-crowd plateau on an                                    t∈[40%,60%) of
              otherwise calm day                                           the duration
  diurnal     synthetic elasticity study:   1.2/s   1400    180      0.45  sinusoid, 5x
              one compressed day/night                                     peak-to-trough,
              load cycle                                                   peak mid-trace
  multiturn   synthetic chat-session study  0.8/s*  512**   192      0.30  Poisson session
              (multi-turn prefix reuse,                                    starts; turns
              DESIGN.md §7): each session                                  gated on the
              runs ~4 turns whose prompt                                   previous turn's
              is the full history plus a                                   completion + an
              fresh user message                                           exp. think gap
                                                                           (mean 12 s)

  tenants     synthetic multi-tenancy       2.0/s   1200    150      0.50  Poisson per tenant
              study (DESIGN.md §10): 4                                     (rate/5 each); the
              well-behaved tenants plus                                    "flood" tenant
              one adversarial flooder                                      ramps 10x over
                                                                           t∈[45%,70%)

  *  multiturn's base_rate counts *sessions* per second; the request rate
     is ~turns_mean higher.
  ** first-turn prompt median; a follow-up prompt is the whole previous
     context (prompt + output) plus a fresh message of median 96 tokens.

``load_trace(name, rate_scale)`` replays at a scaled request rate by dividing
inter-arrival times — the paper's evaluation-workflow trick (§7.1). The MMPP
presets draw arrivals from a 2-state Markov-modulated Poisson process; the
shaped presets (spike/diurnal) draw from a non-homogeneous Poisson process
via thinning against the deterministic rate profile ``rate_at``. The session
preset (multiturn) draws Poisson session starts and emits one request per
turn carrying ``session_id``/``parent_rid``/``history_len``; a follow-up's
nominal arrival is its parent's plus an exponential think gap, and the
serving runtime additionally gates dispatch on the parent actually finishing
(core/runtime.py), so effective arrival = max(nominal, parent finish).
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.request import Request


@dataclass(frozen=True)
class TracePreset:
    name: str
    duration: float            # seconds of trace
    base_rate: float           # requests/second at scale 1.0
    in_median: float
    in_sigma: float            # lognormal sigma
    out_median: float
    out_sigma: float
    in_out_corr: float         # target correlation of log-lengths
    burst_rate_mult: float = 1.0   # MMPP high-state rate multiplier
    burst_frac: float = 0.0        # fraction of time in high state
    max_input: int = 32768
    max_output: int = 4096
    slo_ttft: float = 3.0
    slo_tpot: float = 0.1
    # deterministic rate shaping (elasticity presets): "mmpp" keeps the
    # 2-state MMPP arrivals; "spike"/"diurnal" thin a Poisson process against
    # rate_at(t); "sessions" draws Poisson *session* starts and unrolls each
    # into a gated multi-turn chain (DESIGN.md §7).
    rate_shape: str = "mmpp"
    shape_mult: float = 1.0
    spike_window: Tuple[float, float] = (0.4, 0.6)   # fractions of duration
    # session-preset knobs (rate_shape == "sessions")
    turns_mean: float = 4.0        # geometric mean turns per session
    followup_median: float = 96.0  # fresh user-message tokens per follow-up
    think_mean: float = 12.0       # exp. think-time gap between turns (s)
    # tenancy-preset knobs (rate_shape == "tenants", DESIGN.md §10):
    # n_tenants well-behaved tenants t0..t{n-1} share base_rate evenly; one
    # adversarial "flood" tenant starts at the same per-tenant rate and
    # ramps shape_mult× inside spike_window.
    n_tenants: int = 4

    def rate_at(self, t: float) -> float:
        """Deterministic request rate (req/s) at trace time ``t`` for the
        shaped presets; the MMPP presets return base_rate (their burstiness
        is stochastic)."""
        if self.rate_shape == "spike":
            a, b = self.spike_window
            inside = a * self.duration <= t < b * self.duration
            return self.base_rate * (self.shape_mult if inside else 1.0)
        if self.rate_shape == "diurnal":
            # one full day compressed into `duration`: trough at t=0, peak
            # mid-trace, trough again at the end.
            phase = 0.5 * (1.0 - math.cos(2 * math.pi * t / self.duration))
            return self.base_rate * (1.0 + (self.shape_mult - 1.0) * phase)
        return self.base_rate


TRACE_PRESETS: Dict[str, TracePreset] = {
    "azure_code": TracePreset(
        "azure_code", duration=600.0, base_rate=2.0,
        in_median=2600.0, in_sigma=1.3, out_median=28.0, out_sigma=0.9,
        in_out_corr=0.95, burst_rate_mult=10.0, burst_frac=0.10,
        max_input=32768, max_output=2048, slo_ttft=3.0, slo_tpot=0.1),
    "azure_conv": TracePreset(
        "azure_conv", duration=600.0, base_rate=4.0,
        in_median=1024.0, in_sigma=1.1, out_median=220.0, out_sigma=0.8,
        in_out_corr=0.29, burst_rate_mult=2.5, burst_frac=0.15,
        max_input=16384, max_output=2048, slo_ttft=2.0, slo_tpot=0.15),
    "burstgpt": TracePreset(
        "burstgpt", duration=600.0, base_rate=3.0,
        in_median=620.0, in_sigma=1.0, out_median=190.0, out_sigma=0.7,
        in_out_corr=0.55, burst_rate_mult=8.0, burst_frac=0.10,
        max_input=8192, max_output=1024, slo_ttft=0.25, slo_tpot=0.075),
    "mooncake": TracePreset(
        "mooncake", duration=600.0, base_rate=3.0,
        in_median=14000.0, in_sigma=0.55, out_median=300.0, out_sigma=0.5,
        in_out_corr=0.4, burst_rate_mult=1.0, burst_frac=0.0,
        max_input=131072, max_output=2048, slo_ttft=30.0, slo_tpot=0.1),
    # ---- elasticity presets (DESIGN.md §6): deterministic load shapes that
    # a fixed-size cluster must over-provision for. Exercised by
    # benchmarks/bench_elastic.py and tests/test_autoscaler.py.
    "spike": TracePreset(
        "spike", duration=600.0, base_rate=1.0,
        in_median=1800.0, in_sigma=1.0, out_median=160.0, out_sigma=0.7,
        in_out_corr=0.5, max_input=16384, max_output=1024,
        slo_ttft=2.0, slo_tpot=0.1,
        rate_shape="spike", shape_mult=6.0, spike_window=(0.4, 0.6)),
    "diurnal": TracePreset(
        "diurnal", duration=600.0, base_rate=1.2,
        in_median=1400.0, in_sigma=1.0, out_median=180.0, out_sigma=0.7,
        in_out_corr=0.45, max_input=16384, max_output=1024,
        slo_ttft=2.0, slo_tpot=0.1,
        rate_shape="diurnal", shape_mult=5.0),
    # ---- multi-turn conversation preset (DESIGN.md §7): sessions with a
    # growing shared history — the workload where prefix reuse pays.
    # Exercised by benchmarks/bench_prefix.py and tests/test_prefix.py.
    "multiturn": TracePreset(
        "multiturn", duration=600.0, base_rate=0.8,   # sessions/s
        in_median=512.0, in_sigma=0.8, out_median=192.0, out_sigma=0.6,
        in_out_corr=0.3, max_input=16384, max_output=1024,
        slo_ttft=2.0, slo_tpot=0.1,
        rate_shape="sessions", turns_mean=4.0, followup_median=96.0,
        think_mean=12.0),
    # ---- multi-tenant preset (DESIGN.md §10): heterogeneous tenants plus
    # one adversarial flooder ramping 10× mid-trace — the workload where
    # credit-based admission + WDRR dispatch pay. Exercised by
    # benchmarks/bench_tenants.py and tests/test_tenants.py.
    "tenants": TracePreset(
        "tenants", duration=600.0, base_rate=2.0,
        in_median=1200.0, in_sigma=0.9, out_median=150.0, out_sigma=0.7,
        in_out_corr=0.5, max_input=8192, max_output=1024,
        slo_ttft=2.5, slo_tpot=0.12,
        rate_shape="tenants", shape_mult=10.0, spike_window=(0.45, 0.7),
        n_tenants=4),
}


def _shaped_arrivals(rng: np.random.Generator, p: TracePreset) -> np.ndarray:
    """Non-homogeneous Poisson arrivals against the deterministic rate
    profile ``p.rate_at`` (Lewis–Shedler thinning)."""
    lam_max = p.base_rate * max(p.shape_mult, 1.0)
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= p.duration:
            break
        if rng.random() * lam_max <= p.rate_at(t):
            out.append(t)
    return np.asarray(out)


def _arrivals(rng: np.random.Generator, p: TracePreset, rate: float) -> np.ndarray:
    """2-state MMPP: exponential inter-arrivals at low/high rate, switching
    with exponentially-distributed dwell times."""
    if p.rate_shape != "mmpp":
        return _shaped_arrivals(rng, p)
    lo = rate * (1 - p.burst_frac * p.burst_rate_mult) / max(1 - p.burst_frac, 1e-9)
    lo = max(lo, rate * 0.1)
    hi = rate * p.burst_rate_mult
    t, high = 0.0, False
    dwell_lo, dwell_hi = 60.0, 60.0 * p.burst_frac / max(1 - p.burst_frac, 1e-9)
    next_switch = rng.exponential(dwell_lo)
    out = []
    while t < p.duration:
        r = hi if high else lo
        t += rng.exponential(1.0 / max(r, 1e-9))
        while t >= next_switch:
            high = not high
            next_switch += rng.exponential(dwell_hi if high else dwell_lo)
        if t < p.duration:
            out.append(t)
    return np.asarray(out)


def _session_trace(rng: np.random.Generator, p: TracePreset,
                   rate_scale: float) -> List[Request]:
    """Multi-turn sessions (DESIGN.md §7): Poisson session starts; each
    session runs a geometric number of turns. Turn k's prompt is the whole
    previous context (prompt + output) plus a fresh user message, so
    ``input_len`` grows and ``history_len`` records the shared prefix. The
    nominal arrival of a follow-up is its parent's arrival plus an
    exponential think gap — the runtime gates actual dispatch on the parent
    finishing, so the chain is causally ordered whatever the timings."""
    starts = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / p.base_rate)
        if t >= p.duration:
            break
        starts.append(t)
    chains: List[List[Request]] = []
    for sid, t0 in enumerate(starts):
        n_turns = int(rng.geometric(1.0 / max(p.turns_mean, 1.0)))
        t_arr, ctx = t0, 0
        chain: List[Request] = []
        for k in range(n_turns):
            med = p.in_median if k == 0 else p.followup_median
            z = rng.standard_normal(2)
            fresh = int(np.clip(np.exp(math.log(med) + p.in_sigma * z[0]),
                                16, p.max_input))
            in_len = ctx + fresh
            if in_len > p.max_input:      # history would overflow: end here
                break
            rho = p.in_out_corr
            z_out = rho * z[0] + math.sqrt(max(1 - rho * rho, 0.0)) * z[1]
            out_len = int(np.clip(
                np.exp(math.log(p.out_median) + p.out_sigma * z_out),
                1, p.max_output))
            chain.append(Request(
                rid=-1, arrival=t_arr / rate_scale, input_len=in_len,
                output_len=out_len, session_id=sid, history_len=ctx))
            ctx = in_len + out_len
            t_arr += rng.exponential(p.think_mean)
        if chain:
            chains.append(chain)
    # rids in global arrival order; parent links follow the chain order
    flat = sorted((r for c in chains for r in c), key=lambda r: r.arrival)
    rid_of = {}
    for i, r in enumerate(flat):
        r.rid = i
        rid_of[id(r)] = i
    for chain in chains:
        for parent, child in zip(chain, chain[1:]):
            child.parent_rid = rid_of[id(parent)]
    return flat


def _tenant_trace(rng: np.random.Generator, p: TracePreset,
                  rate_scale: float) -> List[Request]:
    """Multi-tenant workload (DESIGN.md §10): ``n_tenants`` well-behaved
    tenants each drive a homogeneous Poisson stream at ``base_rate /
    n_tenants``; an adversarial "flood" tenant starts at the same
    per-tenant rate and ramps ``shape_mult``× inside ``spike_window``
    (Lewis–Shedler thinning). Lengths are the usual correlated lognormals;
    rids are assigned in global arrival order and every request carries its
    ``tenant_id``."""
    per = p.base_rate / max(p.n_tenants, 1)
    a, b = p.spike_window
    labelled: List[Tuple[float, str]] = []
    for i in range(p.n_tenants):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / per)
            if t >= p.duration:
                break
            labelled.append((t, f"t{i}"))
    lam_max = per * max(p.shape_mult, 1.0)
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= p.duration:
            break
        inside = a * p.duration <= t < b * p.duration
        if rng.random() * lam_max <= per * (p.shape_mult if inside else 1.0):
            labelled.append((t, "flood"))
    labelled.sort(key=lambda x: x[0])
    n = len(labelled)
    rho = p.in_out_corr
    z = rng.standard_normal((n, 2))
    z_out = rho * z[:, 0] + math.sqrt(max(1 - rho * rho, 0.0)) * z[:, 1]
    in_len = np.clip(np.exp(math.log(p.in_median) + p.in_sigma * z[:, 0]),
                     16, p.max_input).astype(int)
    out_len = np.clip(np.exp(math.log(p.out_median) + p.out_sigma * z_out),
                      1, p.max_output).astype(int)
    return [Request(rid=i, arrival=float(labelled[i][0]) / rate_scale,
                    input_len=int(in_len[i]), output_len=int(out_len[i]),
                    tenant_id=labelled[i][1]) for i in range(n)]


def load_trace(name: str, rate_scale: float = 1.0, *, seed: int = 0,
               duration: float | None = None) -> List[Request]:
    """Generate the named trace, then replay it at ``rate_scale``× speed by
    scaling timestamps (the paper's §7.1 evaluation workflow) — every rate
    sees the *same* request sequence, just denser."""
    p = TRACE_PRESETS[name]
    base_duration = duration * rate_scale if duration is not None else p.duration
    p = TracePreset(**{**p.__dict__, "duration": base_duration})
    # NB: stable across processes (builtin hash() is salted per interpreter)
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    if p.rate_shape == "sessions":
        return _session_trace(rng, p, rate_scale)
    if p.rate_shape == "tenants":
        return _tenant_trace(rng, p, rate_scale)
    times = _arrivals(rng, p, p.base_rate) / rate_scale
    n = len(times)
    # correlated lognormal lengths
    rho = p.in_out_corr
    z = rng.standard_normal((n, 2))
    z_in = z[:, 0]
    z_out = rho * z[:, 0] + math.sqrt(max(1 - rho * rho, 0.0)) * z[:, 1]
    in_len = np.clip(np.exp(math.log(p.in_median) + p.in_sigma * z_in),
                     16, p.max_input).astype(int)
    out_len = np.clip(np.exp(math.log(p.out_median) + p.out_sigma * z_out),
                      1, p.max_output).astype(int)
    return [Request(rid=i, arrival=float(times[i]), input_len=int(in_len[i]),
                    output_len=int(out_len[i])) for i in range(n)]


def trace_stats(trace: List[Request], bucket: float = 60.0) -> Dict[str, float]:
    """Per-minute load stats matching the paper's Fig. 1/2 measurements."""
    if not trace:
        return {}
    end = max(r.arrival for r in trace) + 1e-9
    nb = int(math.ceil(end / bucket))
    tot_in = np.zeros(nb)
    tot_out = np.zeros(nb)
    for r in trace:
        b = int(r.arrival // bucket)
        tot_in[b] += r.input_len
        tot_out[b] += r.output_len
    ins = np.asarray([r.input_len for r in trace], float)
    outs = np.asarray([r.output_len for r in trace], float)
    corr = float(np.corrcoef(np.log(ins), np.log(outs))[0, 1]) if len(ins) > 2 else 0.0
    return {
        "n_requests": len(trace),
        "input_cv_per_min": float(tot_in.std() / max(tot_in.mean(), 1e-9)),
        "output_cv_per_min": float(tot_out.std() / max(tot_out.mean(), 1e-9)),
        "in_out_corr": corr,
        "input_median": float(np.median(ins)),
        "output_median": float(np.median(outs)),
        "input_p99": float(np.percentile(ins, 99)),
        "rate_req_s": len(trace) / end,
    }
