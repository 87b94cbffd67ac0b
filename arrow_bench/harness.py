"""One run of one cell: set-up, pre-roll, the measured window, the metrics
of the window, then the comparison that decides ``correct``.

``run_cell`` takes its device from the caller: ``run.py`` refuses to run
without a card, and the tests drive the same function on the CPU at a
small size (the program runs its kernels' plain versions there).
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from arrow_bench import correct, readers, traffic
from arrow_bench.bench import Cell, metric_readers
from arrow_bench.serve import (Recorder, Req, build_cluster, serve,
                               warm_up)
from arrow_bench.trace import Profile, Slicer

# top-level module names no run may hold once its window has closed: JAX,
# and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the metric readers read."""
    conf: dict
    mix: dict
    family: object
    window: tuple
    slo: tuple
    setup_s: float
    requests: List[Req]
    migrations: List[dict] = field(default_factory=list)
    passes: List[tuple] = field(default_factory=list)
    dispatches: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    profile: Optional[Profile] = None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """One run; returns the result line's fields (``compared`` last) and
    ``info`` (numbers printed on an earlier line). With ``control`` the
    float8 reference's tokens are judged in place of the program's."""
    dev = torch.device(device)
    seed = int(seed) % (1 << 63)
    conf, mix = cell.conf, cell.mix
    info: Dict[str, object] = {"cell": cell.name, "seed": seed,
                               "card": power_limit(dev)}
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(cell.family.KERNELS)
        torch.cuda.reset_peak_memory_stats(dev)
    info["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = cell.reference.init_weights(conf, seed, dev)
    info["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        cluster = build_cluster(cell, params, dev, seed)
        info["cluster_s"] = time.perf_counter() - t
        t = time.perf_counter()
        warm_up(cluster, cell, seed, conf["vocab_size"])
        info["warmup_s"] = time.perf_counter() - t
        result = _window(cell, cluster, dev, seed, seconds, trace, t_start,
                         info)
        reqs = result.pop("_run").requests
        del cluster
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        chosen = correct.sample(reqs, seed, mix["sample_tokens"])
        g = correct.gaps(cell, params, chosen, control=control)
        info["reference_s"] = time.perf_counter() - t
    info["sample"] = {"requests": len(chosen), **g}
    wrong = correct.wrong_length(reqs)
    limit = conf["correct"]["max_logit_gap"]
    # the control's picks stand in the program's place and are judged alike
    gap = g["control_gap"] if control else g["logit_gap"]
    ok = (bool(chosen) and limit is not None and gap <= limit
          and wrong == 0 and result["failed"] == 0)
    result["correct"] = bool(ok)
    result["compared"] = {
        "logit_gap": {"value": gap, "limit": limit},
        "wrong_length": {"value": wrong, "limit": 0}}
    result["info"] = info
    return result


def _window(cell, cluster, dev, seed, seconds, trace, t_start, info,
            rate=None, rid_base=0):
    """The cell's traffic (pre-roll, then the measured window) at its rate,
    or at ``rate`` (the knee sweep, whose rates share one cluster and so
    number their requests from ``rid_base``); returns the result line's
    fields and the window's ``Run`` under ``_run``."""
    mix = cell.mix
    rate = cell.rate["rate_req_s"] if rate is None else rate
    preroll = mix["preroll_s"]
    arrivals = traffic.requests(mix, rate, preroll, seconds, seed,
                                cell.conf["vocab_size"])
    for a in arrivals:
        a.rid += rid_base
    clock = cluster.clock
    t0 = clock.now()
    setup_s = time.perf_counter() - t_start
    open_, close = t0 + preroll, t0 + preroll + seconds
    reqs: Dict[int, Req] = {}
    recorder = Recorder(clock, reqs).install() if trace else None
    slicer = (Slicer(clock, dev, close - mix["profile_slice_s"],
                     mix["profile_slice_s"])
              if trace and dev.type == "cuda" else None)
    passes: Optional[list] = [] if trace else None
    marks = {}

    def on_time(now):
        if "open" not in marks and now >= open_:
            marks["open"] = len(cluster.migration_log)
            marks["backlog_open"] = _backlog(reqs)
            marks["decoding_open"] = sum(1 for r in reqs.values()
                                         if r.tokens and not r.finished)
        if slicer is not None:
            slicer.on_time(now, recorder)

    try:
        serve(cluster, arrivals, t0, close, reqs, recorder, passes, on_time)
        marks["close"] = len(cluster.migration_log)
        if slicer is not None:
            if slicer.profile is None and slicer.prof is None:
                slicer.begin(recorder)
            serve(cluster, arrivals, t0, slicer.ends_at, reqs, recorder,
                  passes)
            slicer.stop(recorder)
    finally:
        if recorder is not None:
            recorder.remove()
    info["backlog_open_close"] = [marks.get("backlog_open"), _backlog(reqs)]
    info["decoding_at_open"] = marks.get("decoding_open")
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    run = Run(conf=cell.conf, mix=mix, family=cell.family,
              window=(open_, close), slo=(mix["slo_ttft_s"],
                                          mix["slo_tpot_s"]),
              setup_s=setup_s, requests=list(reqs.values()),
              migrations=cluster.migration_log[
                  marks.get("open", marks["close"]):marks["close"]],
              passes=passes or [],
              dispatches=recorder.dispatches if recorder else [],
              spans=recorder.spans if recorder else [],
              profile=slicer.profile if slicer else None)
    metrics = {}
    readers_ = metric_readers(cell, trace)
    for m in cell.metrics(trace):
        v = readers_[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = readers.in_window(run)
    ttft = readers.ttfts(run)
    info.update({
        "setup_s": setup_s, "rate_req_s": rate,
        "due_in_window": len(due),
        "finished_in_window": sum(1 for r in run.requests if r.finished
                                  and r.times and open_ <= r.times[-1]
                                  < close),
        "ttft_p50_p90_ms": [readers.percentile(ttft, q) * 1e3
                            if ttft else None for q in (50, 90)],
        "itl_p95_ms": (readers.percentile(readers.token_gaps(run), 95)
                       or 0.0) * 1e3,
        "slo_met_in_window": readers.good_in_window(run),
        "late_submit_ms_max": 1e3 * max(
            (r.submitted - r.due for r in run.requests), default=0.0),
        "migrations_in_window": len(run.migrations)})
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"attempted": len(due),
           "failed": sum(1 for r in due if r.rejected),
           "metrics": metrics, "device": device,
           "_run": run}
    if run.profile is not None:
        p = run.profile
        device["busy_s"] = p.busy_s()
        device["window_s"] = p.wall
        out["breakdown"] = {"device_ops": p.top_ops(),
                            "idle_gaps": p.idle_by_host(run.spans)}
        info["profile_collect_s"] = p.collect_s
        info["profile_events"] = len(p.events)
    return out


def _backlog(reqs) -> int:
    """Requests submitted and not yet finished."""
    return sum(1 for r in reqs.values() if not r.finished)
