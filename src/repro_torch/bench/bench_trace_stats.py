"""Paper Fig. 1 / Fig. 2 + §3.1: workload diversity statistics of the four
synthesized traces vs the published targets."""
from __future__ import annotations

from repro_torch.bench.common import Timer, emit, save_json
from repro_torch.traces import TRACE_PRESETS, load_trace, trace_stats

# published targets (paper §3.1)
TARGETS = {
    "azure_code": {"input_cv_per_min": 0.80, "in_out_corr": 0.95},
    "azure_conv": {"in_out_corr": 0.29},
    "burstgpt": {"input_cv_per_min": 1.11},
    "mooncake": {"input_cv_per_min": 0.16},
}


def main() -> None:
    out = {}
    for name in TRACE_PRESETS:
        with Timer() as t:
            tr = load_trace(name, seed=0)
            s = trace_stats(tr)
        out[name] = {"stats": s, "targets": TARGETS.get(name, {})}
        derived = (f"cv={s['input_cv_per_min']:.2f};r={s['in_out_corr']:.2f};"
                   f"med_in={s['input_median']:.0f};n={s['n_requests']}")
        emit(f"trace_stats.{name}", t.us / max(len(tr), 1), derived)
    save_json("trace_stats", out)


if __name__ == "__main__":
    main()
