"""Runs one benchmark cell traced with the program's own spans and
counters (``repro_torch.core.trace``) attached, and prints what
``arrow_bench/program_spans.py`` reads from them:

    python3 tools/trace_cell.py --workload qwen3-1.7b.code --seed 7 \\
        --seconds 51 [--out results/trace_cell.jsonl]

Temporary: it stands in for the harness until the harness's traced run
attaches the tracer itself, and then goes. Until then it patches the
harness from outside, for one ``run_cell`` with a trace: a ``Tracer`` on
the cluster at the first ``serve`` call (traffic's start, after warm-up);
the sleeps of ``serve`` (nothing in flight) kept as ``harness.wait``; a
second clock marker launched on the device as the profiled slice closes
(``clock_skew_us``); the window's ``Run`` kept for the readers; and, from
the tracer's attachment on, the crc32 kernel's launches and the calls of
its host path (zlib), beside the ``migration.checksum`` spans; the
sums of a constant-state family's dispatch counters (``state_sums``); and
the window's decode graph replays and captures beside its dispatched
decode steps (``graph``).
Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STATE_COUNTERS = ("state_bytes", "state_reserved_bytes", "chunk_calls")


class _Sleeps:
    """``serve``'s ``time``: the module, with ``sleep`` timed on the
    cluster's clock."""

    def __init__(self, clock, waits):
        self.clock, self.waits = clock, waits

    def __getattr__(self, name):
        return getattr(time, name)

    def sleep(self, s):
        a = self.clock.now()
        time.sleep(s)
        self.waits.append((a, self.clock.now()))


@contextlib.contextmanager
def attached():
    """Patch the harness for one run; yields what the run leaves behind."""
    import torch
    from arrow_bench import harness, serve as serve_mod
    from arrow_bench.trace import Slicer
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.crc32 import crc32_op, ops as crc_ops
    cap = {"cluster": None, "run": None, "waits": [], "close_host": None,
           "crc_launches": 0, "crc_host_calls": 0}
    orig_serve, orig_window = harness.serve, harness._window
    orig_stop, orig_host = Slicer.stop, crc_ops.crc32_host

    def serve(cluster, *args, **kw):
        if cap["cluster"] is None:
            cap["cluster"] = cluster
            cluster.tracer = Tracer(cluster.clock)
            serve_mod.time = _Sleeps(cluster.clock, cap["waits"])
            cap["crc_launches"] = -crc32_op.launches
            crc_ops.crc32_host = host
        return orig_serve(cluster, *args, **kw)

    def host(*args, **kw):
        cap["crc_host_calls"] += 1
        return orig_host(*args, **kw)

    def window(*args, **kw):
        out = orig_window(*args, **kw)
        cap["run"] = out["_run"]
        return out

    def stop(self, recorder):
        if self.prof is not None:
            torch.cuda.synchronize(self.device)
            cap["close_host"] = self.clock.now()
            torch.zeros(1, device=self.device)       # the closing marker
        orig_stop(self, recorder)

    harness.serve, harness._window, Slicer.stop = serve, window, stop
    try:
        yield cap
    finally:
        harness.serve, harness._window = orig_serve, orig_window
        serve_mod.time, Slicer.stop = time, orig_stop
        crc_ops.crc32_host = orig_host
        cap["crc_launches"] += crc32_op.launches


def span_cost_us(n: int = 20000) -> float:
    """Host microseconds of one span opened and closed on a wall clock."""
    from repro_torch.core.clock import WallClock
    from repro_torch.core.trace import Tracer
    tr = Tracer(WallClock())
    t = time.perf_counter()
    for _ in range(n):
        tr.close(tr.open("x", 0))
    return 1e6 * (time.perf_counter() - t) / n


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from arrow_bench.run import cache_env
    cache_env()
    import torch
    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 1
    from arrow_bench import program_spans as ps
    from arrow_bench.bench import load_cell
    from arrow_bench.harness import run_cell
    cell = load_cell(ROOT, args.workload)
    with contextlib.redirect_stdout(sys.stderr), attached() as cap:
        out = run_cell(cell, args.seed, args.seconds, True, "cuda", t_start)
    run, tr = cap["run"], cap["cluster"].tracer
    a, b = run.window
    _, counts = ps.steps(run, tr)
    trace = {"metrics": {k: f(run, tr) for k, f in ps.METRICS.items()},
             **ps.info(run, tr),
             # a constant-state family's dispatch counters, summed over the
             # window's dispatched steps (absent, 0, for a dense one)
             "state_sums": {k: sum(c.get(k, 0) for c in counts)
                            for k in STATE_COUNTERS},
             # the decode graph (engine/decode_graph.py): replays, captures
             # inside dispatches, and the dispatched steps that decoded
             "graph": {"replays": sum(c.get("graph_replays", 0)
                                      for c in counts),
                       "captures": sum(c.get("graph_captures", 0)
                                       for c in counts),
                       "decode_dispatches": sum(
                           1 for c in counts if c["decode_rows"] > 0)},
             "harness_wait_s": sum(e - s for s, e in cap["waits"]
                                   if a <= s < b),
             **ps.idle_by_span(run, tr, cap["waits"], cap["close_host"]),
             "crc32": {"launches": cap["crc_launches"],
                       "host_calls": cap["crc_host_calls"],
                       "checksum_spans": tr.names.count(
                           "migration.checksum"),
                       "migrations": tr.names.count("migration")}}
    line = {"workload": args.workload, "seed": args.seed,
            "card": out["info"]["card"], "correct": out["correct"],
            "metrics": out["metrics"], "breakdown": out.get("breakdown"),
            "device": out["device"], "span_cost_us": span_cost_us(),
            "trace": trace, "info": out["info"]}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
