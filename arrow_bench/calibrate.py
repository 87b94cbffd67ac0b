"""The chip-side tools that set a cell's numbers; the benchmark's own runs
never call them.

``sweep`` finds a cell's knee: one process, one cluster, then for each
rate the cell's traffic (pre-roll and a window of ``--seconds``) at that
rate through the harness's own window, after which the window's requests
are let finish. For each rate it
prints the share of the window's requests that met both SLOs, the backlog
(requests submitted and unfinished) as the window opened and as it closed,
the TTFT and token-gap tails and the output rate. The knee is the highest
rate at which at least 90% met both and the backlog did not grow.

``control`` runs the cell as ``run.py`` does for each seed (one process)
and judges, in the program's place, the control: the plain reference in
float8, at the same positions; the program's own widest gap is printed
beside it. ``--fault exchange`` instead judges the program with a fault
planted: no migrated state reaches its decode slot. Each run has to come
out not correct; the tool exits 1 if one does not.

    python3 arrow_bench/calibrate.py sweep --workload W --rates 0.5,1,2 \\
        --seconds 30 --seed 1
    python3 arrow_bench/calibrate.py control --workload W --seeds 1,2,3 \\
        --seconds 20
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from arrow_bench import readers, run  # noqa: E402


def sweep(cell, rates, seconds: float, seed: int, drain_s: float,
          device="cuda"):
    import torch

    from arrow_bench.harness import _window, power_limit
    from arrow_bench.serve import build_cluster, warm_up
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(cell.family.KERNELS)
    params = cell.reference.init_weights(cell.conf, seed, dev)
    with torch.no_grad():
        cluster = build_cluster(cell, params, dev, seed)
        warm_up(cluster, cell, seed, cell.conf["vocab_size"])
        print(json.dumps({"cell": cell.name, "card": power_limit(dev),
                          "setup_s": time.perf_counter() - T_START}),
              flush=True)
        for k, rate in enumerate(rates):
            info = {}
            out = _window(cell, cluster, dev, seed, seconds, False, T_START,
                          info, rate=rate, rid_base=1_000_000 * (k + 1))
            run_ = out.pop("_run")
            cluster.drain(timeout=drain_s)
            due = readers.in_window(run_)
            met = sum(1 for r in due if readers.meets_slo(r, run_.slo))
            print(json.dumps({
                "rate": rate, "due": len(due),
                "met_share": met / max(len(due), 1),
                "finished_after_drain": sum(r.finished for r in due),
                "unfinished_after_drain": sum(not r.finished
                                              for r in run_.requests),
                "backlog_open_close": info["backlog_open_close"],
                "decoding_at_open": info["decoding_at_open"],
                "ttft_p90_ms_window": info["ttft_p50_p90_ms"][1],
                "metrics": {n: m["value"]
                            for n, m in out["metrics"].items()}}),
                flush=True)


def drop_migrated_state():
    """Plant a fault: a migration's state never reaches the decode slot."""
    from repro_torch.engine import kv_slots, state_slots

    def place_nothing(self, rid, payload, length):
        self.len_of[rid] = length
    kv_slots.SlotKVCache.place_state = place_nothing
    state_slots._FixedStateSlots.place_state = place_nothing


def control(cell, seeds, seconds: float, fault: str) -> int:
    """Runs that have to come out not correct: the float8 control judged
    in the program's place, or the program with ``fault`` planted. Returns
    the number that came out correct (0 is the pass)."""
    from arrow_bench.harness import run_cell
    if fault == "exchange":
        drop_migrated_state()
    passed = 0
    for seed in seeds:
        t = time.perf_counter()
        out = run_cell(cell, seed, seconds, False, "cuda", t,
                       control=fault == "none")
        info = out.pop("info")
        passed += bool(out["correct"])
        print(json.dumps({"seed": seed, "fault": fault,
                          "sample": info["sample"],
                          "correct": out["correct"],
                          "compared": out["compared"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "metrics": out["metrics"],
                          "reference_s": info["reference_s"]}), flush=True)
    return passed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tool", choices=("sweep", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--drain", type=float, default=120.0)
    ap.add_argument("--fault", choices=("none", "exchange"), default="none")
    args = ap.parse_args(argv)
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    from arrow_bench.bench import load_cell
    cell = load_cell(ROOT, args.workload)
    if args.tool == "sweep":
        sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds,
              args.seed, args.drain)
    elif control(cell, [int(s) for s in args.seeds.split(",")],
                 args.seconds, args.fault):
        run.fail("a control or fault run came out correct")


if __name__ == "__main__":
    main()
