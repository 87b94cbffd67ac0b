from repro_torch.traces.synth import TRACE_PRESETS, load_trace, trace_stats  # noqa: F401
