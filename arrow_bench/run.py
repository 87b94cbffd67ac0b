"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 arrow_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell, its configuration, mix, rate and metrics are found by name from
``BENCHMARK.json`` (see ``bench.py``). The program under test is the
PyTorch port in ``src/repro_torch`` beside this folder. A run needs a CUDA
card (it never falls back to the CPU), builds the port's kernels into a
fixed directory inside the checkout (``.arrow_bench_cache/``), and exits
non-zero without a result when the card is missing, the program is
missing, or JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".arrow_bench_cache"


def fail(msg: str, code: int = 1):
    print(f"arrow_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a checkout's first run builds."""
    for var, sub in (("REPRO_TORCH_BUILD_DIR", "kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program (src/repro_torch) is not in {ROOT}")
    cache_env()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from arrow_bench.bench import load_cell
    from arrow_bench.harness import forbidden_modules, run_cell
    cell = load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.workload["chips"]:
        fail(f"{args.workload} needs {cell.workload['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    # the program's own prints must not land after the result line
    with contextlib.redirect_stdout(sys.stderr):
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded: {bad}")
    info = out.pop("info")
    print(json.dumps(info), file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = out["compared"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
